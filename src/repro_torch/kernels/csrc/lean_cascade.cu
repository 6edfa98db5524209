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
// about a quarter of the K/V that K2 reads on the same batch.
//
// Design. The TPU kernel ran the whole descriptor array as one sequential
// grid with every partial in VMEM. Here the CTAs run in parallel, so the
// fix-up is K2's (lean_decode.cu), applied to targets instead of segments:
//   * one CTA per stream-K worker; a CTA walks its worker's columns of the
//     prefix section, then of the suffix section, of the fused descriptors
//     (the combined segment and piece numbering of
//     CascadeSchedule.fused_partial_descriptors) and updates the segment's
//     rows against one K/V tile from pool row route[i], masked to
//     ctx_all[seg] (attn::tile_update at the prefix bucket QB or at g);
//   * on a LAST column it flushes the un-scaled (o, m, l) of the segment's
//     rows into the global f32 scratch (P_tot + 1, qmax, d);
//   * a flushed piece feeds several targets: a prefix piece of (pass j,
//     head h) feeds members[j, i] * H + h for every member rank i, a suffix
//     piece its own segment. The host derives piece -> targets from the
//     merge section of the descriptors. For each target the CTA fences and
//     bumps the target's arrival counter; the CTA whose arrival completes a
//     target merges that target's merge columns in descriptor order.
// Padding ranks (members -1), the garbage target B * H and the garbage
// piece P_tot never reach the lists. No CTA waits for another, so any grid
// is right whether or not its CTAs are co-resident, and since every target
// is merged in one fixed order by one CTA, the result is deterministic: a
// cascade over shared pages equals the same cascade over duplicated pages
// bit for bit (the reference's contract, tests/test_cascade.py:133).
//
// int8 pools (dtype code 2): bf16 queries, int8 K/V rows and a float32
// scale per pool row for K and for V; each partial column reads its routed
// row's scales once and attn::tile_update dequantizes as K1 and K2 do. The
// merge reads only f32 partials.
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch.

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::Smem;

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };
constexpr int kMaxTargets = 64;   // targets one piece can feed (the pass's members)

struct Args {
  const void* q_pref;      // (nph, qmax, d) stacked member queries of each prefix segment
  const void* q_suf;       // (S, g, d) queries of each suffix segment
  const void* k_rows;      // (R, tile, d) pool rows
  const void* v_rows;
  const float* k_scales;   // (R,) int8 rows only
  const float* v_scales;
  const int* desc;         // (7, n_desc) fused descriptors: partial then merge section
  const int* ctx_all;      // (nph + S,) runtime lengths, prefix segments first
  const int* route;        // (n_part,) pool row per partial column
  const int* tgt_start;    // (S,) descriptor column of each target's first merge column
  const int* tgt_count;    // (S,) its merge columns = pieces it waits for
  const int* pt_start;     // (P_tot + 1,) piece -> targets, CSR offsets
  const int* pt_tgt;       // targets, piece-major
  int* arrivals;           // (S,) zeroed by the caller
  float* o_p;              // (P_tot + 1, qmax, d) piece partials
  float* m_p;              // (P_tot + 1, qmax)
  float* l_p;
  float* o;                // (S, g, d)
  float* lse;              // (S, g)
  int n_desc, n_pref, tp, ts, nph, qmax, g, d, tile;
  float scale;
};

// Merge target `t`: its merge columns in descriptor order; column c reads
// rows [rank * g, (rank + 1) * g) of piece c. Scratch is read with
// ld.global.cg: other CTAs wrote it.
__device__ void merge_target(const Args& a, int t) {
  const int N = a.n_desc, d = a.d, g = a.g;
  const int base = a.tgt_start[t], count = a.tgt_count[t];
  for (int e = threadIdx.x; e < g * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    float acc = 0.f, m = kNegInf, l = 0.f;
    for (int k = 0; k < count; ++k) {
      const int i = base + k;
      const int piece = a.desc[DESC_PIECE * N + i];
      const int row = a.desc[DESC_TILE * N + i] * g + r;
      attn::merge_piece(__ldcg(a.o_p + ((size_t)piece * a.qmax + row) * d + c),
                        __ldcg(a.m_p + (size_t)piece * a.qmax + row),
                        __ldcg(a.l_p + (size_t)piece * a.qmax + row), acc, m, l);
    }
    a.o[(size_t)t * g * d + e] = acc / l;
    if (c == 0) a.lse[(size_t)t * g + r] = m + logf(l);
  }
}

// Q: the queries' type; KV: the K/V rows' (Q, or int8_t with scales).
template <typename Q, typename KV, int GB, int QB>
__global__ void __launch_bounds__(kThreads) lean_cascade_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* stage = reinterpret_cast<int8_t*>(smem_raw);
  const Smem s = attn::carve_smem<QB>(
      reinterpret_cast<float*>(smem_raw + attn::stage_bytes<KV>(a.d, a.tile)), a.d, a.tile);
  __shared__ int merge_list[kMaxTargets];
  __shared__ int n_merge;
  const int d = a.d, tile = a.tile, N = a.n_desc;
  const KV* k_rows = static_cast<const KV*>(a.k_rows);
  const KV* v_rows = static_cast<const KV*>(a.v_rows);
  const size_t row_elems = (size_t)tile * d;
  const int w = blockIdx.x;

  for (int t = 0; t < a.tp + a.ts; ++t) {
    // the worker's prefix columns, then its suffix columns
    const int i = t < a.tp ? w * a.tp + t : a.n_pref + w * a.ts + (t - a.tp);
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) continue;  // padding column
    const int seg = a.desc[DESC_SEG * N + i];
    const int tile_idx = a.desc[DESC_TILE * N + i];
    const int piece = a.desc[DESC_PIECE * N + i];
    const bool first = a.desc[DESC_FIRST * N + i] != 0;
    const bool last = a.desc[DESC_LAST * N + i] != 0;
    const bool prefix = seg < a.nph;
    const int rows = prefix ? a.qmax : a.g;

    if (prefix) {
      if (first) attn::reset_decode_rows<QB>(s, d);
      attn::load_decode_q<Q, QB>(static_cast<const Q*>(a.q_pref) + (size_t)seg * a.qmax * d,
                                 rows, s, d);
    } else {
      if (first) attn::reset_decode_rows<GB>(s, d);
      attn::load_decode_q<Q, GB>(
          static_cast<const Q*>(a.q_suf) + (size_t)(seg - a.nph) * a.g * d, rows, s, d);
    }
    const int vlen = min(max(a.ctx_all[seg] - tile_idx * tile, 0), tile);
    const size_t row = (size_t)a.route[i];
    float ks = 1.f, vs = 1.f;
    if constexpr (attn::is_int8<KV>) {
      ks = a.k_scales[row];
      vs = a.v_scales[row];
    }
    __syncthreads();

    if (prefix)
      attn::tile_update<KV, QB>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                                tile, a.scale, ks, vs, stage);
    else
      attn::tile_update<KV, GB>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                                tile, a.scale, ks, vs, stage);

    if (last) {
      attn::flush_rows(s, rows, d, a.o_p + (size_t)piece * a.qmax * d,
                       a.m_p + (size_t)piece * a.qmax, a.l_p + (size_t)piece * a.qmax);
      __threadfence();  // this thread's piece writes, device-wide
      __syncthreads();
      if (threadIdx.x == 0) {
        int n = 0;
        for (int k = a.pt_start[piece]; k < a.pt_start[piece + 1]; ++k) {
          const int tgt = a.pt_tgt[k];
          if (atomicAdd(a.arrivals + tgt, 1) + 1 == a.tgt_count[tgt]) merge_list[n++] = tgt;
        }
        n_merge = n;
      }
      __syncthreads();
      if (n_merge > 0) {
        __threadfence();
        for (int k = 0; k < n_merge; ++k) merge_target(a, merge_list[k]);
      }
    }
    __syncthreads();  // shared state is reused by the next column
  }
}

template <typename Q, typename KV, int GB, int QB>
cudaError_t launch_typed(const Args& a, int num_workers, cudaStream_t stream) {
  if constexpr (QB < GB) {  // the stacked rows are at least one member's g
    return cudaErrorInvalidValue;
  } else {
    auto kernel = lean_cascade_kernel<Q, KV, GB, QB>;
    const size_t smem = attn::smem_bytes(QB, a.d, a.tile) + attn::stage_bytes<KV>(a.d, a.tile);
    if (smem > 48 * 1024) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<num_workers, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename Q, typename KV, int GB>
cudaError_t launch_q(const Args& a, int num_workers, cudaStream_t stream) {
  switch (attn::row_bucket(a.qmax)) {
    case 2: return launch_typed<Q, KV, GB, 2>(a, num_workers, stream);
    case 4: return launch_typed<Q, KV, GB, 4>(a, num_workers, stream);
    case 8: return launch_typed<Q, KV, GB, 8>(a, num_workers, stream);
    case 16: return launch_typed<Q, KV, GB, 16>(a, num_workers, stream);
    case 32: return launch_typed<Q, KV, GB, 32>(a, num_workers, stream);
    case 64: return launch_typed<Q, KV, GB, 64>(a, num_workers, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Q, typename KV>
cudaError_t launch_g(const Args& a, int num_workers, cudaStream_t stream) {
  switch (a.g) {
    case 2: return launch_q<Q, KV, 2>(a, num_workers, stream);
    case 4: return launch_q<Q, KV, 4>(a, num_workers, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries and K/V rows share it), 2 =
// bf16 queries with int8 K/V rows and their float32 row scales (NULL
// otherwise).
int lean_cascade_fused_launch(int dtype, const void* q_pref, const void* q_suf,
                              const void* k_rows, const void* v_rows, const float* k_scales,
                              const float* v_scales, const int* desc,
                              int n_desc, int n_pref, int tp, int ts, int num_workers,
                              const int* ctx_all, const int* route, const int* tgt_start,
                              const int* tgt_count, const int* pt_start, const int* pt_tgt,
                              int* arrivals, float* o_p, float* m_p, float* l_p, float* o,
                              float* lse, int nph, int qmax, int g, int d, int tile,
                              float scale, void* stream) {
  Args a = {q_pref, q_suf,  k_rows, v_rows, k_scales, v_scales, desc,  ctx_all, route,
            tgt_start, tgt_count,
            pt_start, pt_tgt, arrivals, o_p,  m_p,   l_p,   o,     lse,
            n_desc,  n_pref, tp,     ts,     nph,   qmax,  g,     d,     tile,  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_workers <= 0 || d <= 0 || tile <= 0 || qmax < g || qmax > 64)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_g<float, float>(a, num_workers, st);
    case 1: return (int)launch_g<__nv_bfloat16, __nv_bfloat16>(a, num_workers, st);
    case 2:
      if (k_scales == nullptr || v_scales == nullptr || d % attn::kVec)
        return (int)cudaErrorInvalidValue;
      return (int)launch_g<__nv_bfloat16, int8_t>(a, num_workers, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
