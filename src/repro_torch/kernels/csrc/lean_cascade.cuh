// Fused cascade decode (K5): what its two kernels share -- the arguments,
// the last arriver's fix-up and the launch at the instantiation the
// operands pick. lean_cascade.cu walks the tiles on the decode ring,
// lean_cascade_walk.cu in device memory; the host picks the library by the
// ring's slot count (kernels/decode_ring.py), and both give the same bits.
// The design is described in lean_cascade.cu.
#pragma once

#include "attn_decode_ring.cuh"

namespace cascade {


using attn::kNegInf;
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
  int* arrivals;           // (S,) zero at launch; each target's last arriver re-zeroes it
  float* o_p;              // (P_tot + 1, qmax, d) piece partials
  float* m_p;              // (P_tot + 1, qmax)
  float* l_p;
  float* o;                // (S, g, d)
  float* lse;              // (S, g)
  int n_desc, n_pref, tp, ts, nph, qmax, g, d, tile;
  float scale;
};

// Merge the n targets of `list`: each target's merge columns in descriptor
// order; column c reads rows [rank * g, (rank + 1) * g) of piece c. A
// thread owns W columns of one row of one target and folds them with
// attn::fold_pieces, the batched fold K2's fix-up runs too.
template <int W, int NT>
__device__ void merge_targets_w(const Args& a, const int* list, int n) {
  const int N = a.n_desc, d = a.d, g = a.g, per_row = d / W, items = g * per_row;
  for (int e = threadIdx.x; e < n * items; e += NT) {
    const int t = list[e / items], item = e % items;
    const int r = item / per_row, c = item % per_row * W;
    const int base = a.tgt_start[t];
    float acc[W], m = kNegInf, l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.f;
    attn::fold_pieces<W>(a.o_p, a.m_p, a.l_p, d, c, a.tgt_count[t], [&](int k) {
      const int i = base + k;
      return (size_t)a.desc[DESC_PIECE * N + i] * a.qmax + a.desc[DESC_TILE * N + i] * g + r;
    }, acc, m, l);
    float* o = a.o + ((size_t)t * g + r) * d + c;
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = acc[w] / l;
    if (c == 0) a.lse[(size_t)t * g + r] = m + logf(l);
  }
}

template <int NT>
__device__ __forceinline__ void merge_targets(const Args& a, const int* list, int n) {
  if (a.d % 4 == 0)
    merge_targets_w<4, NT>(a, list, n);
  else
    merge_targets_w<1, NT>(a, list, n);
}

// A piece's last column, on NT threads that `sync` syncs: flush the
// piece's rows to scratch, count its arrival at every target it feeds, and
// merge the targets whose last piece this was.
template <int NT, typename Sync>
__device__ __forceinline__ void finish_piece(const Args& a, const Smem& s, int piece, int rows,
                                             int* merge_list, int* n_merge, Sync sync) {
  attn::flush_rows<NT>(s, rows, a.d, a.o_p + (size_t)piece * a.qmax * a.d,
                       a.m_p + (size_t)piece * a.qmax, a.l_p + (size_t)piece * a.qmax);
  __threadfence();  // this thread's piece writes, device-wide
  sync();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = a.pt_start[piece]; k < a.pt_start[piece + 1]; ++k) {
      const int tgt = a.pt_tgt[k];
      if (atomicAdd(a.arrivals + tgt, 1) + 1 == a.tgt_count[tgt]) {
        a.arrivals[tgt] = 0;   // left zeroed for the next launch
        merge_list[n++] = tgt;
      }
    }
    *n_merge = n;
  }
  sync();
  if (*n_merge > 0) {
    __threadfence();
    merge_targets<NT>(a, merge_list, *n_merge);
  }
}

// Kernel<Q, KV, GB, QB>::launch(a, num_workers, ns, stream) at g (GB) and
// the row bucket of qmax (QB), for the dtype code of the C entry point.
template <template <typename, typename, int, int> class Kernel, typename Q, typename KV, int GB>
cudaError_t launch_q(const Args& a, int num_workers, int ns, cudaStream_t stream) {
  switch (attn::row_bucket(a.qmax)) {
    case 2: return Kernel<Q, KV, GB, 2>::launch(a, num_workers, ns, stream);
    case 4: return Kernel<Q, KV, GB, 4>::launch(a, num_workers, ns, stream);
    case 8: return Kernel<Q, KV, GB, 8>::launch(a, num_workers, ns, stream);
    case 16: return Kernel<Q, KV, GB, 16>::launch(a, num_workers, ns, stream);
    case 32: return Kernel<Q, KV, GB, 32>::launch(a, num_workers, ns, stream);
    case 64: return Kernel<Q, KV, GB, 64>::launch(a, num_workers, ns, stream);
    default: return cudaErrorInvalidValue;
  }
}

// At the row bucket of g (GB): 2 (g 1, 2), 4 (3, 4), 8 (5-8); rows g..GB-1
// of a suffix segment are zero queries whose results are never written. A
// source that defines CASCADE_MAX_GB 4 leaves out the g 5-8 bucket (the
// walk over device memory: a bucket of 8 would add a third to the
// longest build of the kernels; the host refuses g > 4 off the ring).
#ifndef CASCADE_MAX_GB
#define CASCADE_MAX_GB 8
#endif
template <template <typename, typename, int, int> class Kernel, typename Q, typename KV>
cudaError_t launch_g(const Args& a, int num_workers, int ns, cudaStream_t stream) {
  switch (attn::row_bucket(a.g)) {
    case 2: return launch_q<Kernel, Q, KV, 2>(a, num_workers, ns, stream);
    case 4: return launch_q<Kernel, Q, KV, 4>(a, num_workers, ns, stream);
#if CASCADE_MAX_GB >= 8
    case 8: return launch_q<Kernel, Q, KV, 8>(a, num_workers, ns, stream);
#endif
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (queries and K/V rows share it), 2 =
// bf16 queries with int8 K/V rows and their float32 row scales, 3 = bf16
// queries with e4m3 K/V rows (no scales).
template <template <typename, typename, int, int> class Kernel>
int launch(int dtype, const Args& a, int num_workers, int ns, cudaStream_t stream) {
  if (num_workers <= 0 || a.d <= 0 || a.tile <= 0 || a.qmax < a.g || a.qmax > 64)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_g<Kernel, float, float>(a, num_workers, ns, stream);
    case 1: return (int)launch_g<Kernel, __nv_bfloat16, __nv_bfloat16>(a, num_workers, ns, stream);
    case 2:
      if (a.k_scales == nullptr || a.v_scales == nullptr || a.d % attn::kVec)
        return (int)cudaErrorInvalidValue;
      return (int)launch_g<Kernel, __nv_bfloat16, int8_t>(a, num_workers, ns, stream);
    case 3:
      if (a.d % attn::kVec) return (int)cudaErrorInvalidValue;
      return (int)launch_g<Kernel, __nv_bfloat16, attn::e4m3>(a, num_workers, ns, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cascade

// The C entry point of a K5 library, which launches Kernel: dtype as
// cascade::launch; ns the ring's slots (0: the walk over device memory),
// which each library checks against what its kernel takes. Returns the
// launch's cudaError_t.
#define LEAN_CASCADE_ENTRY(Kernel)                                                             \
  extern "C" int lean_cascade_fused_launch(                                                    \
      int dtype, const void* q_pref, const void* q_suf, const void* k_rows,                  \
      const void* v_rows, const float* k_scales, const float* v_scales, const int* desc,     \
      int n_desc, int n_pref, int tp, int ts, int num_workers, const int* ctx_all,           \
      const int* route, const int* tgt_start, const int* tgt_count, const int* pt_start,     \
      const int* pt_tgt, int* arrivals, float* o_p, float* m_p, float* l_p, float* o,        \
      float* lse, int nph, int qmax, int g, int d, int tile, float scale, int ns,            \
      void* stream) {                                                                        \
    const cascade::Args a = {q_pref,    q_suf,     k_rows,   v_rows,   k_scales, v_scales,   \
                             desc,      ctx_all,   route,    tgt_start, tgt_count, pt_start, \
                             pt_tgt,    arrivals,  o_p,      m_p,      l_p,      o,          \
                             lse,       n_desc,    n_pref,   tp,       ts,       nph,        \
                             qmax,      g,         d,        tile,     scale};               \
    return cascade::launch<Kernel>(dtype, a, num_workers, ns,                                \
                                   static_cast<cudaStream_t>(stream));                       \
  }
