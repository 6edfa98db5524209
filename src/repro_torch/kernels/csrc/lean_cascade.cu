// Fused cascade (prefix-grouped) decode for Hopper: K5.
//
// Replaces the Pallas TPU kernel of the reference:
//   K5  repro/kernels/lean_decode.py:604  _lean_cascade_fused_kernel
//       (driven by lean_cascade_fused :715)
//
// What it computes. Sequences that share a prompt prefix through the radix
// cache alias the same KV pages. The cascade splits decode attention into
// two stream-K phases and merges them with the associative softmax
// re-scaling operator (paper section IV-A), all in one launch:
//   prefix phase  one segment per (grouped pass, kv head) whose query block
//                 stacks every member's g query rows (qmax = nmax * g rows),
//                 walking the pass's shared pages once for the whole group;
//   suffix phase  one segment per (sequence, kv head) with its g rows over
//                 its private tail pages;
//   merge         per target (sequence, kv head): the rows [rank * g,
//                 (rank + 1) * g) of each prefix piece of each pass the
//                 sequence sits in (shallow pass first), then its suffix
//                 pieces, folded in descriptor order into o = acc / l and
//                 lse = m + log l.
//
// What bounds it on this card: bytes. Like K2 it does 4 * rows flops per
// K/V element pair it reads, far below the ~295 flops/byte ridge point; its
// floor is the shared prefix's K/V read once per pass, the suffixes' K/V,
// and the f32 partials written once and read once by the merge. Reading the
// shared pages once for the group instead of once per member is the whole
// point of the cascade: with 4 members on a long shared prompt it reads
// about a quarter of the K/V that K2 reads on the same batch. At the main
// path's shapes a worker has one or two columns, so what sets its time is
// latency: its tiles' loads, and the fix-up's loads of every piece of a
// target. The design takes both off the critical path.
//
// Design. The TPU kernel ran the whole descriptor array as one sequential
// grid with every partial in VMEM. Here the CTAs run in parallel, so the
// fix-up is K2's (lean_decode.cu), applied to targets instead of segments:
//   * one CTA per stream-K worker; a CTA walks its worker's columns of the
//     prefix section, then of the suffix section, of the fused descriptors
//     (the combined segment and piece numbering of
//     CascadeSchedule.fused_partial_descriptors) and updates the segment's
//     rows against one K/V tile from pool row route[i], masked to
//     ctx_all[seg], at the prefix bucket QB or at g. A tile's visible rows
//     are contiguous in the pool, so the walk runs on the decode ring of
//     attn_decode_ring.cuh: the producer warp reads the descriptors, the
//     routes and (int8) the scales ahead of the consumers and keeps the
//     next columns' K and V in flight into shared-memory slots, while 256
//     consumer threads run ring::tile_update (the update K1, K2 and K6 run
//     on their rings too) on the staged tile and load Q, and their register
//     slice of it, only when the segment changes. Where the ring does not fit
//     (the host passes ns = 0: a float32 page of 256 keys, a bf16 page of
//     256 beside the 64-row bucket, rows whose bytes are not a multiple of
//     16) the CTA walks the tiles in device memory with attn::tile_update
//     (lean_cascade_walk.cu); the bits are the same either way;
//   * on a LAST column it flushes the un-scaled (o, m, l) of the segment's
//     rows into the global f32 scratch (P_tot + 1, qmax, d);
//   * a flushed piece feeds several targets: a prefix piece of (pass j,
//     head h) feeds members[j, i] * H + h for every member rank i, a suffix
//     piece its own segment. The host derives piece -> targets from the
//     merge section of the descriptors. For each target the CTA fences and
//     bumps the target's arrival counter; the CTA whose arrival completes a
//     target merges that target's merge columns in descriptor order with
//     attn::fold_pieces, the loads of 8 pieces in flight before it folds
//     them (K2's fix-up runs the same fold).
// Padding ranks (members -1), the garbage target B * H and the garbage
// piece P_tot never reach the lists. No CTA waits for another, so any grid
// is right whether or not its CTAs are co-resident, and since every target
// is merged in one fixed order by one CTA, the result is deterministic: a
// cascade over shared pages equals the same cascade over duplicated pages
// bit for bit (the reference's contract, tests/test_cascade.py:133).
//
// int8 pools (dtype code 2): bf16 queries, int8 K/V rows and a float32
// scale per pool row for K and for V; each partial column's routed row's
// scales are read once and the update dequantizes as K1 and K2 do. The
// merge reads only f32 partials.
//
// f8 pools (dtype code 3): bf16 queries and e4m3 K/V rows, no scales; the
// rows go through the ring as int8 rows do and are widened as they are
// read (attn_tile.cuh).
//
// This file holds the ring's kernel; the walk over device memory is in
// lean_cascade_walk.cu, and what both share in lean_cascade.cuh. Plain C
// interface (loaded with ctypes); the entry point returns the cudaError_t
// of its launch.

#include "lean_cascade.cuh"

namespace {

using namespace cascade;

// The producer's lane: the worker's prefix columns, then its suffix
// columns, through ring::produce.
template <typename KV>
__device__ void produce_columns(const Args& a, const ring::Ring& r, ring::Col* cols) {
  const int N = a.n_desc, w = blockIdx.x, tile = a.tile;
  ring::produce<KV>(a.tp + a.ts, [&](int t, ring::Col& c, size_t& row) {
    const int i = t < a.tp ? w * a.tp + t : a.n_pref + w * a.ts + (t - a.tp);
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) return false;  // padding column
    c.seg = a.desc[DESC_SEG * N + i];
    c.piece = a.desc[DESC_PIECE * N + i];
    c.flags = (a.desc[DESC_FIRST * N + i] != 0 ? ring::kFirst : 0) |
              (a.desc[DESC_LAST * N + i] != 0 ? ring::kLast : 0);
    c.vlen = min(max(a.ctx_all[c.seg] - a.desc[DESC_TILE * N + i] * tile, 0), tile);
    row = (size_t)a.route[i];
    return true;
  }, a.k_rows, a.v_rows, a.k_scales, a.v_scales, a.d, tile, r, cols);
}

// The walk on the ring: the producer warp reads the descriptors and copies
// the tiles ahead; the consumers load Q when the segment changes, update on
// the staged rows and finish each piece.
template <typename Q, typename KV, int GB, int QB>
__global__ void __launch_bounds__(ring::kThreads, 1) lean_cascade_ring_kernel(Args a, int ns) {
  constexpr int NC = ring::kConsumers;
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ uint64_t full[ring::kMaxSlots], empty[ring::kMaxSlots];
  __shared__ ring::Col cols[ring::kMaxSlots];
  __shared__ int merge_list[kMaxTargets];
  __shared__ int n_merge;
  const int d = a.d, tile = a.tile;
  const uint32_t slot = (uint32_t)ring::slot_bytes(sizeof(KV), d, tile);
  const ring::Ring r{ring_raw, slot, ns, full, empty};
  const Smem s =
      attn::carve_smem<QB>(reinterpret_cast<float*>(ring_raw + (size_t)ns * slot), d, tile);
  if (threadIdx.x == 0) ring::init(r);
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp
    if (threadIdx.x == NC) produce_columns<KV>(a, r, cols);
    return;
  }
  ring::cta_stamp(0);
  ring::QSlice<QB> qs;  // the queries of segment `cur`, also in s.q
  int cur = -1;
  for (int n = 0;; n += 2) {
    ring::wait(r, n);
    const ring::Col c = cols[n % ns];
    if (c.seg < 0) break;
    const bool prefix = c.seg < a.nph, new_q = c.seg != cur;
    const int rows = prefix ? a.qmax : a.g;
    if (prefix) {
      if (c.flags & ring::kFirst) attn::reset_decode_rows<QB, NC>(s, d);
      if (new_q)
        attn::load_decode_q<Q, QB, NC>(
            static_cast<const Q*>(a.q_pref) + (size_t)c.seg * a.qmax * d, rows, s, d);
    } else {
      if (c.flags & ring::kFirst) attn::reset_decode_rows<GB, NC>(s, d);
      if (new_q)
        attn::load_decode_q<Q, GB, NC>(
            static_cast<const Q*>(a.q_suf) + (size_t)(c.seg - a.nph) * a.g * d, rows, s, d);
    }
    cur = c.seg;
    ring::sync_consumers();
    if (new_q) qs.load(s, d);

    if (prefix)
      ring::tile_update<KV, QB>(r, n, c.vlen, s, qs, d, tile, a.scale, c.ks, c.vs);
    else
      ring::tile_update<KV, GB>(r, n, c.vlen, s, qs, d, tile, a.scale, c.ks, c.vs);

    if (c.flags & ring::kLast)
      finish_piece<NC>(a, s, c.piece, rows, merge_list, &n_merge, ring::ConsumerSync());
  }
  ring::cta_stamp(2);
}

template <typename Q, typename KV, int GB, int QB>
struct RingKernel {
  static cudaError_t launch(const Args& a, int num_workers, int ns, cudaStream_t stream) {
    if constexpr (QB < GB) {  // the stacked rows are at least one member's g
      return cudaErrorInvalidValue;
    } else {
      const size_t state = attn::smem_bytes(QB, a.d, a.tile);
      if (ns == 0 || !ring::fits(ns, sizeof(KV), a.d, a.tile, state) ||
          (uintptr_t)a.k_rows % 16 || (uintptr_t)a.v_rows % 16)
        return cudaErrorInvalidValue;
      auto kernel = lean_cascade_ring_kernel<Q, KV, GB, QB>;
      const size_t smem = ns * ring::slot_bytes(sizeof(KV), a.d, a.tile) + state;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<num_workers, ring::kThreads, smem, stream>>>(a, ns);
      return cudaGetLastError();
    }
  }
};

}  // namespace

// ns >= 2 slots, K/V rows 16-byte aligned.
LEAN_CASCADE_ENTRY(RingKernel)
