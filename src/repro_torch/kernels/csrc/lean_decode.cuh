// Stream-K decode (K1, K2): what its two kernels share -- the arguments,
// K2's last-arriver fix-up, and the launch at the instantiation the
// operands pick. lean_decode.cu walks the tiles on the decode ring,
// lean_decode_walk.cu in device memory; the host picks the library by the
// ring's slot count (kernels/decode_ring.py), and both give the same bits.
// The design is described in lean_decode.cu.
#pragma once

#include "attn_decode_ring.cuh"

namespace lean {

using attn::kNegInf;
using attn::Smem;

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };

struct Args {
  const void* q;        // (S, gq, d)
  const void* k_rows;   // (R, tile, d)
  const void* v_rows;
  const float* k_scales;  // (R,) int8 rows only
  const float* v_scales;
  const int* desc;      // (7, n_cols)
  const int* seg_ctx;   // (S,)
  const int* route;     // (n_cols,) pool row per column
  float* o_p;           // (P+1, gq, d) piece partials (K1 output, K2 scratch)
  float* m_p;           // (P+1, gq)
  float* l_p;
  // K2 only
  const int* piece_start;  // (S,)
  const int* piece_count;  // (S,)
  int* arrivals;           // (S,) zero at launch; each segment's last arriver re-zeroes it
  float* o;                // (S, gq, d)
  float* lse;              // (S, gq)
  int n_cols, tiles_per_worker, gq, d, tile;
  float scale;
};

// K2's fix-up on NT threads: fold pieces [start, start + count) of `seg` in
// piece order (repro/kernels/lean_decode.py:358-381) with
// attn::fold_pieces, W columns of one row a thread, then write o and lse.
template <int W, int NT>
__device__ void merge_segment_w(const Args& a, int seg, int gq) {
  const int start = a.piece_start[seg], d = a.d, per_row = d / W;
  for (int e = threadIdx.x; e < gq * per_row; e += NT) {
    const int r = e / per_row, c = e % per_row * W;
    float acc[W], m = kNegInf, l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.f;
    attn::fold_pieces<W>(a.o_p, a.m_p, a.l_p, d, c, a.piece_count[seg],
                         [&](int k) { return (size_t)(start + k) * gq + r; }, acc, m, l);
    float* o = a.o + ((size_t)seg * gq + r) * d + c;
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = acc[w] / l;
    if (c == 0) a.lse[(size_t)seg * gq + r] = m + logf(l);
  }
}

template <int NT>
__device__ __forceinline__ void merge_segment(const Args& a, int seg, int gq) {
  if (a.d % 4 == 0)
    merge_segment_w<4, NT>(a, seg, gq);
  else
    merge_segment_w<1, NT>(a, seg, gq);
}

// A piece's last column, on NT threads that `sync` syncs: flush the
// piece's rows (StorePartials, Algorithm 2 lines 20-22) -- K1's output --
// and, for K2, fence, count the piece's arrival at its segment and merge
// the segment if this was its last piece. Nobody waits for anybody, so the
// kernel is right for any grid. `merge_here` is a shared flag.
template <bool FUSED, int NT, typename Sync>
__device__ __forceinline__ void finish_piece(const Args& a, const Smem& s, int seg, int piece,
                                             int gq, int* merge_here, Sync sync) {
  attn::flush_rows<NT>(s, gq, a.d, a.o_p + (size_t)piece * gq * a.d,
                       a.m_p + (size_t)piece * gq, a.l_p + (size_t)piece * gq);
  if constexpr (FUSED) {
    __threadfence();  // this thread's piece writes, device-wide
    sync();
    if (threadIdx.x == 0) {
      const bool last = atomicAdd(a.arrivals + seg, 1) + 1 == a.piece_count[seg];
      if (last) a.arrivals[seg] = 0;   // left zeroed for the next launch
      *merge_here = last;
    }
    sync();
    if (*merge_here) {
      __threadfence();
      merge_segment<NT>(a, seg, gq);
    }
  }
}

// Kernel<Q, KV, QB, EXACT, FUSED>::launch(a, num_workers, ns, stream) at
// the row bucket of gq: exact instantiations (gq == QB, bounds known at
// compile time) for the configs' g of 2 and 4, the buckets 2-64 otherwise.
template <template <typename, typename, int, bool, bool> class Kernel, typename Q, typename KV,
          bool FUSED>
cudaError_t launch_rows(const Args& a, int num_workers, int ns, cudaStream_t stream) {
  if (a.gq == 2) return Kernel<Q, KV, 2, true, FUSED>::launch(a, num_workers, ns, stream);
  if (a.gq == 4) return Kernel<Q, KV, 4, true, FUSED>::launch(a, num_workers, ns, stream);
  switch (attn::row_bucket(a.gq)) {
    case 2: return Kernel<Q, KV, 2, false, FUSED>::launch(a, num_workers, ns, stream);
    case 4: return Kernel<Q, KV, 4, false, FUSED>::launch(a, num_workers, ns, stream);
    case 8: return Kernel<Q, KV, 8, false, FUSED>::launch(a, num_workers, ns, stream);
    case 16: return Kernel<Q, KV, 16, false, FUSED>::launch(a, num_workers, ns, stream);
    case 32: return Kernel<Q, KV, 32, false, FUSED>::launch(a, num_workers, ns, stream);
    case 64: return Kernel<Q, KV, 64, false, FUSED>::launch(a, num_workers, ns, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, k_rows and v_rows share it), 2 =
// bf16 q with int8 k_rows and v_rows and their float32 row scales, 3 = bf16
// q with e4m3 k_rows and v_rows (no scales).
template <template <typename, typename, int, bool, bool> class Kernel, bool FUSED>
int launch(int dtype, const Args& a, int num_workers, int ns, cudaStream_t st) {
  if (num_workers <= 0 || a.d <= 0 || a.tile <= 0 || a.gq <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_rows<Kernel, float, float, FUSED>(a, num_workers, ns, st);
    case 1:
      return (int)launch_rows<Kernel, __nv_bfloat16, __nv_bfloat16, FUSED>(a, num_workers, ns,
                                                                           st);
    case 2:
      if (a.k_scales == nullptr || a.v_scales == nullptr || a.d % attn::kVec)
        return (int)cudaErrorInvalidValue;
      return (int)launch_rows<Kernel, __nv_bfloat16, int8_t, FUSED>(a, num_workers, ns, st);
    case 3:
      if (a.d % attn::kVec) return (int)cudaErrorInvalidValue;
      return (int)launch_rows<Kernel, __nv_bfloat16, attn::e4m3, FUSED>(a, num_workers, ns, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lean

// The C entry points of a K1/K2 library, which launch Kernel: dtype as
// lean::launch (k_scales and v_scales NULL but for int8 rows); ns the
// ring's slots (0: the walk over device memory), which each library checks
// against what its kernel takes. Each returns the cudaError_t of its
// launch.
#define LEAN_DECODE_ENTRY(Kernel)                                                              \
  extern "C" int lean_decode_partials_launch(                                                  \
      int dtype, const void* q, const void* k_rows, const void* v_rows, const float* k_scales, \
      const float* v_scales, const int* desc, int n_cols, int tiles_per_worker,                \
      int num_workers, const int* seg_ctx, const int* route, float* o_p, float* m_p,           \
      float* l_p, int gq, int d, int tile, float scale, int ns, void* stream) {                \
    const lean::Args a = {q,       k_rows,  v_rows,  k_scales, v_scales, desc,    seg_ctx,     \
                          route,   o_p,     m_p,     l_p,      nullptr,  nullptr, nullptr,     \
                          nullptr, nullptr, n_cols,  tiles_per_worker,  gq,       d,           \
                          tile,    scale};                                                     \
    return lean::launch<Kernel, false>(dtype, a, num_workers, ns,                              \
                                       static_cast<cudaStream_t>(stream));                     \
  }                                                                                            \
  extern "C" int lean_decode_fused_launch(                                                     \
      int dtype, const void* q, const void* k_rows, const void* v_rows, const float* k_scales, \
      const float* v_scales, const int* desc, int n_cols, int tiles_per_worker,                \
      int num_workers, const int* seg_ctx, const int* route, const int* piece_start,           \
      const int* piece_count, int* arrivals, float* o_p, float* m_p, float* l_p, float* o,     \
      float* lse, int gq, int d, int tile, float scale, int ns, void* stream) {                \
    const lean::Args a = {q,           k_rows,      v_rows,   k_scales, v_scales, desc,        \
                          seg_ctx,     route,       o_p,      m_p,      l_p,      piece_start, \
                          piece_count, arrivals,    o,        lse,      n_cols,                \
                          tiles_per_worker,         gq,       d,        tile,     scale};      \
    return lean::launch<Kernel, true>(dtype, a, num_workers, ns,                               \
                                      static_cast<cudaStream_t>(stream));                      \
  }
