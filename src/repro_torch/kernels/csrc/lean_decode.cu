// Stream-K (LeanAttention) decode kernels for Hopper: K1 (partials) and
// K2 (partials + per-segment fix-up in one launch).
//
// Replaces the Pallas TPU kernels of the reference:
//   K1  repro/kernels/lean_decode.py:117  _lean_decode_kernel
//       (int8 body :135, paged twin :535, driven by lean_decode_partials :177)
//   K2  repro/kernels/lean_decode.py:302  _lean_decode_fused_kernel
//       (int8 body :321, paged twin :539, driven by lean_decode_fused :401)
//
// What bounds them on this card: decode attention at gq = 4 query rows per
// KV head does 4 * gq flops per K/V element pair it reads, far below the
// H100's ~295 flops/byte ridge point, so the time floor is the K/V bytes of
// the tokens actually attended divided by the HBM rate. But a worker's
// columns are a short chain -- at the main path's shapes 3-4 tiles -- and
// each CTA runs alone on its SM, so what sets the time is how fast one SM
// gets through its chain: the latency of its tiles' loads and the compute
// of each update, then the fix-up's loads of a segment's pieces.
//
// Structure. One CTA per stream-K worker (grid = num_workers). A worker
// walks its T descriptor columns in order; each valid column is one
// LeanTile online-softmax update of the segment's gq query rows against one
// tile x d K/V tile, pool row route[i], masked to the runtime length
// vlen = clamp(ctx[seg] - tile_idx * tile, 0, tile). A tile's visible K
// and V rows are contiguous in the pool, so the walk runs on the decode
// ring of attn_decode_ring.cuh: the producer warp reads the worker's
// descriptor columns (skipping padding), the routes and (int8) the row's
// scales, and bulk-copies each column's K and then V rows into
// shared-memory slots, its Col beside the K copy -- with 6 slots of a bf16
// tile at the 4-row bucket, 3 tiles are in flight, nearly all of a
// worker's walk. 256 consumer threads take each column's segment from its
// Col, load Q (and their register slice of it) only when the segment
// changes, reset (m, l, acc) on FIRST and run ring::tile_update on the
// staged tile. On the column that ends a piece they flush the un-scaled
// (o, m, l):
//
//   K1 writes the piece to row `piece` of (P+1, gq, d) / (P+1, gq) f32
//      outputs; the phase-2 merge runs outside (segment_merge).
//   K2 writes the piece to a global f32 scratch, fences, and bumps the
//      segment's arrival counter. The CTA whose arrival completes the
//      segment (count == piece_count[seg]) merges the segment's pieces in
//      piece order -- the order of the reference's fused merge rows -- with
//      attn::fold_pieces (8 pieces' loads in flight, 4 columns a float4),
//      and writes o = acc / l and lse = m + log l. Nobody waits for
//      anybody, so the kernel is correct whether or not all CTAs are
//      co-resident. (The TPU kernel ran its grid sequentially with
//      partials in VMEM, lean_decode.py:19-33; that trick has no place on
//      a GPU.)
//
// Where the ring does not fit (the host passes ns = 0: float32 pages of
// 256, bf16 pages of 256 beside the 64-row bucket, rows whose bytes are not
// a multiple of 16) the CTA walks the tiles in device memory with attn::tile_update
// (lean_decode_walk.cu, a library of its own so that the two build in
// parallel). Every sum keeps its order on both walks, so the bits are the
// same either way.
//
// Row counts. The kernels are instantiated for row buckets QB in
// {2, 4, 8, 16, 32, 64} and take any gq <= 64 at run time: rows past gq
// are zero query rows whose results are never written. gq 2 and 4 (the
// configs' g) run exact instantiations (EXACT: gq == QB), whose q load,
// flush and merge are bounded at compile time; the cascade's two-call path
// runs K1 on the prefix pass with the stacked member rows (nmax * g, up to
// 64) through the bucketed ones.
//
// int8 pools (the reference's quantized=True bodies): with dtype code 2 the
// K/V rows are int8 and each pool row has a float32 scale per K and V
// (k_scales, v_scales). The producer reads a column's two scales into its
// Col, the int8 rows go through the ring like bf16 ones (a tile of d 128
// is 16 KB), and the update dequantizes each element as float(x) * scale
// before it enters a product. The queries stay bf16. K2's fix-up reads
// only the f32 partials, so no scale is read there.
//
// f8 pools (dtype code 3): e4m3 K/V rows, no scales, through the ring as
// int8 rows go (a tile of d 128 is 16 KB), each element widened to float32
// as it is read -- exact, so K1/K2 on e4m3 rows give their bf16 forms'
// bits on the rows widened to bf16.
//
// Descriptors are the packed (7, G*T) int32 rows of
// LeanSchedule.packed_descriptors(): SEG, TILE, PIECE, FIRST, LAST, LEN,
// VALID. Dense KV runs through the same kernels: a dense (S, S_pad, d)
// cache is already a pool of (S * S_pad / tile) rows of tile x d.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "lean_decode.cuh"

namespace {

using namespace lean;

// Q: the queries' type; KV: the K/V rows' (Q, or int8_t with scales).
template <typename Q, typename KV, int QB, bool EXACT, bool FUSED>
__global__ void __launch_bounds__(ring::kThreads, 1) lean_decode_ring_kernel(Args a, int ns) {
  constexpr int NC = ring::kConsumers;
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ uint64_t full[ring::kMaxSlots], empty[ring::kMaxSlots];
  __shared__ ring::Col cols[ring::kMaxSlots];
  __shared__ int merge_here;
  const int d = a.d, tile = a.tile, gq = EXACT ? QB : a.gq;
  const uint32_t slot = (uint32_t)ring::slot_bytes(sizeof(KV), d, tile);
  const ring::Ring r{ring_raw, slot, ns, full, empty};
  const Smem s =
      attn::carve_smem<QB>(reinterpret_cast<float*>(ring_raw + (size_t)ns * slot), d, tile);
  if (threadIdx.x == 0) ring::init(r);
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp
    if (threadIdx.x != NC) return;
    const int N = a.n_cols, T = a.tiles_per_worker, w = blockIdx.x;
    ring::produce<KV>(T, [&](int t, ring::Col& c, size_t& row) {
      const int i = w * T + t;
      if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) return false;  // padding column
      c.seg = a.desc[DESC_SEG * N + i];
      c.piece = a.desc[DESC_PIECE * N + i];
      c.flags = (a.desc[DESC_FIRST * N + i] != 0 ? ring::kFirst : 0) |
                (a.desc[DESC_LAST * N + i] != 0 ? ring::kLast : 0);
      c.vlen = min(max(a.seg_ctx[c.seg] - a.desc[DESC_TILE * N + i] * tile, 0), tile);
      row = (size_t)a.route[i];
      return true;
    }, a.k_rows, a.v_rows, a.k_scales, a.v_scales, d, tile, r, cols);
    return;
  }

  ring::cta_stamp(0);
  const Q* q = static_cast<const Q*>(a.q);
  ring::QSlice<QB> qs;  // the queries of segment `cur`, also in s.q
  int cur = -1;
  for (int n = 0;; n += 2) {
    ring::wait(r, n);
    const ring::Col c = cols[n % ns];
    if (c.seg < 0) break;
    const bool new_q = c.seg != cur;
    if (c.flags & ring::kFirst) attn::reset_decode_rows<QB, NC>(s, d);  // Algorithm 1 lines 8-9
    if (new_q) attn::load_decode_q<Q, QB, NC>(q + (size_t)c.seg * gq * d, gq, s, d);
    cur = c.seg;
    ring::sync_consumers();
    if (new_q) qs.load(s, d);

    ring::tile_update<KV, QB>(r, n, c.vlen, s, qs, d, tile, a.scale, c.ks, c.vs);

    if (c.flags & ring::kLast)
      finish_piece<FUSED, NC>(a, s, c.seg, c.piece, gq, &merge_here, ring::ConsumerSync());
  }
  ring::cta_stamp(2);
}

template <typename Q, typename KV, int QB, bool EXACT, bool FUSED>
struct RingKernel {
  static cudaError_t launch(const Args& a, int num_workers, int ns, cudaStream_t stream) {
    const size_t state = attn::smem_bytes(QB, a.d, a.tile);
    if (ns == 0 || !ring::fits(ns, sizeof(KV), a.d, a.tile, state) ||
        (uintptr_t)a.k_rows % 16 || (uintptr_t)a.v_rows % 16)
      return cudaErrorInvalidValue;
    auto kernel = lean_decode_ring_kernel<Q, KV, QB, EXACT, FUSED>;
    const size_t smem = ns * ring::slot_bytes(sizeof(KV), a.d, a.tile) + state;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<num_workers, ring::kThreads, smem, stream>>>(a, ns);
    return cudaGetLastError();
  }
};

}  // namespace

// ns >= 2 slots, K/V rows 16-byte aligned.
LEAN_DECODE_ENTRY(RingKernel)
