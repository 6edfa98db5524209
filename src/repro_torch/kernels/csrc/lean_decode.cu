// Stream-K (LeanAttention) decode kernels for Hopper: K1 (partials) and
// K2 (partials + per-segment fix-up in one launch).
//
// Replaces the Pallas TPU kernels of the reference:
//   K1  repro/kernels/lean_decode.py:117  _lean_decode_kernel
//       (paged twin :535, driven by lean_decode_partials :177)
//   K2  repro/kernels/lean_decode.py:302  _lean_decode_fused_kernel
//       (paged twin :539, driven by lean_decode_fused :401)
//
// What bounds them on this card: decode attention at gq = 4 query rows per
// KV head does 4 * gq flops per K/V element pair it reads, far below the
// H100's ~295 flops/byte ridge point, so the time floor is the K/V bytes of
// the tokens actually attended divided by the HBM rate. The design reads
// each valid K and V element exactly once, straight from its pool row
// (no staging copy), skips the masked tail of a tile instead of loading it,
// and keeps scores, probabilities and the running accumulator in shared
// memory. It is the simple, right version: no TMA, no wgmma, no
// multi-stage pipelining yet.
//
// Structure. One CTA per stream-K worker (grid = num_workers). A worker
// walks its T descriptor columns in order; each valid column is one
// LeanTile online-softmax update (attn::tile_update in attn_tile.cuh, shared
// by K1, K2 and K6) of the segment's gq query rows against one tile x d K/V
// tile read from pool row route[i], masked to the runtime length
// vlen = clamp(ctx[seg] - tile_idx * tile, 0, tile). On the column that
// ends a piece the CTA flushes the un-scaled (o, m, l).
//
//   K1 writes the piece to row `piece` of (P+1, gq, d) / (P+1, gq) f32
//      outputs; the phase-2 merge runs outside (segment_merge).
//   K2 writes the piece to a global f32 scratch, fences, and bumps the
//      segment's arrival counter. The CTA whose arrival completes the
//      segment (count == piece_count[seg]) merges the segment's pieces in
//      piece order -- the order of the reference's fused merge rows -- and
//      writes o = acc / l and lse = m + log l. Nobody waits for anybody,
//      so the kernel is correct whether or not all CTAs are co-resident.
//      (The TPU kernel ran its grid sequentially with partials in VMEM,
//      lean_decode.py:19-33; that trick has no place on a GPU.)
//
// Descriptors are the packed (7, G*T) int32 rows of
// LeanSchedule.packed_descriptors(): SEG, TILE, PIECE, FIRST, LAST, LEN,
// VALID. Dense KV runs through the same kernels: a dense (S, S_pad, d)
// cache is already a pool of (S * S_pad / tile) rows of tile x d.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::Smem;

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };

struct Args {
  const void* q;        // (S, GQ, d)
  const void* k_rows;   // (R, tile, d)
  const void* v_rows;
  const int* desc;      // (7, n_cols)
  const int* seg_ctx;   // (S,)
  const int* route;     // (n_cols,) pool row per column
  float* o_p;           // (P+1, GQ, d) piece partials (K1 output, K2 scratch)
  float* m_p;           // (P+1, GQ)
  float* l_p;
  // K2 only
  const int* piece_start;  // (S,)
  const int* piece_count;  // (S,)
  int* arrivals;           // (S,) zeroed by the caller
  float* o;                // (S, GQ, d)
  float* lse;              // (S, GQ)
  int n_cols, tiles_per_worker, d, tile;
  float scale;
};

// K2's fix-up: merge pieces [start, start + count) of `seg` in piece order
// (repro/kernels/lean_decode.py:358-381), then write o and lse. Scratch is
// read with ld.global.cg: other CTAs wrote it, so L1 must be bypassed.
template <int GQ>
__device__ void merge_segment(const Args& a, int seg) {
  const int start = a.piece_start[seg], count = a.piece_count[seg];
  const int d = a.d;
  for (int e = threadIdx.x; e < GQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    float acc = 0.f, m = kNegInf, l = 0.f;
    for (int p = start; p < start + count; ++p) {
      const float mp = __ldcg(a.m_p + (size_t)p * GQ + r);
      const float lp = __ldcg(a.l_p + (size_t)p * GQ + r);
      const float op = __ldcg(a.o_p + ((size_t)p * GQ + r) * d + c);
      const float m_new = fmaxf(m, mp);
      const float a_old = expf(m - m_new);
      const float a_new = expf(mp - m_new);
      l = a_old * l + a_new * lp;
      acc = a_old * acc + a_new * op;
      m = m_new;
    }
    a.o[((size_t)seg * GQ + r) * d + c] = acc / l;
    if (c == 0) a.lse[(size_t)seg * GQ + r] = m + logf(l);
  }
}

template <typename T, int GQ, bool FUSED>
__global__ void __launch_bounds__(kThreads) lean_decode_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const Smem s = attn::carve_smem<GQ>(smem_raw, a.d, a.tile);
  __shared__ int merge_here;
  const int d = a.d, tile = a.tile, N = a.n_cols;
  const T* q = static_cast<const T*>(a.q);
  const T* k_rows = static_cast<const T*>(a.k_rows);
  const T* v_rows = static_cast<const T*>(a.v_rows);
  const size_t row_elems = (size_t)tile * d;

  const int g = blockIdx.x;
  for (int t = 0; t < a.tiles_per_worker; ++t) {
    const int i = g * a.tiles_per_worker + t;
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) continue;  // padding column
    const int seg = a.desc[DESC_SEG * N + i];
    const int tile_idx = a.desc[DESC_TILE * N + i];
    const int piece = a.desc[DESC_PIECE * N + i];
    const bool first = a.desc[DESC_FIRST * N + i] != 0;
    const bool last = a.desc[DESC_LAST * N + i] != 0;

    if (first) {  // Algorithm 1 lines 8-9
      for (int e = threadIdx.x; e < GQ * d; e += kThreads) s.acc[e] = 0.f;
      if (threadIdx.x < GQ) {
        s.m[threadIdx.x] = kNegInf;
        s.l[threadIdx.x] = 0.f;
      }
    }
    const T* qs = q + (size_t)seg * GQ * d;
    for (int e = threadIdx.x; e < GQ * d; e += kThreads) s.q[e] = attn::to_float(qs[e]);
    const int vlen = min(max(a.seg_ctx[seg] - tile_idx * tile, 0), tile);
    const size_t row = (size_t)a.route[i];
    __syncthreads();

    attn::tile_update<T, GQ>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                       tile, a.scale);

    if (last) {  // StorePartials (Algorithm 2 lines 20-22)
      for (int e = threadIdx.x; e < GQ * d; e += kThreads)
        a.o_p[(size_t)piece * GQ * d + e] = s.acc[e];
      if (threadIdx.x < GQ) {
        a.m_p[(size_t)piece * GQ + threadIdx.x] = s.m[threadIdx.x];
        a.l_p[(size_t)piece * GQ + threadIdx.x] = s.l[threadIdx.x];
      }
      if (FUSED) {
        __threadfence();  // this thread's piece writes, device-wide
        __syncthreads();
        if (threadIdx.x == 0)
          merge_here = atomicAdd(a.arrivals + seg, 1) + 1 == a.piece_count[seg];
        __syncthreads();
        if (merge_here) {
          __threadfence();
          merge_segment<GQ>(a, seg);
        }
      }
    }
    __syncthreads();  // shared state is reused by the next column
  }
}

template <typename T, int GQ, bool FUSED>
cudaError_t launch_typed(const Args& a, int num_workers, cudaStream_t stream) {
  auto kernel = lean_decode_kernel<T, GQ, FUSED>;
  const size_t smem = attn::smem_bytes(GQ, a.d, a.tile);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_workers, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FUSED>
cudaError_t launch_gq(const Args& a, int gq, int num_workers, cudaStream_t stream) {
  switch (gq) {
    case 2: return launch_typed<T, 2, FUSED>(a, num_workers, stream);
    case 4: return launch_typed<T, 4, FUSED>(a, num_workers, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED>
int launch(int dtype, const Args& a, int gq, int num_workers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_workers <= 0 || a.d <= 0 || a.tile <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_gq<float, FUSED>(a, gq, num_workers, st);
    case 1: return (int)launch_gq<__nv_bfloat16, FUSED>(a, gq, num_workers, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_rows and v_rows share it).
int lean_decode_partials_launch(int dtype, const void* q, const void* k_rows,
                                const void* v_rows, const int* desc, int n_cols,
                                int tiles_per_worker, int num_workers, const int* seg_ctx,
                                const int* route, float* o_p, float* m_p, float* l_p, int gq,
                                int d, int tile, float scale, void* stream) {
  Args a = {q,       k_rows,  v_rows,  desc,    seg_ctx, route,   o_p,
            m_p,     l_p,     nullptr, nullptr, nullptr, nullptr, nullptr,
            n_cols,  tiles_per_worker, d, tile, scale};
  return launch<false>(dtype, a, gq, num_workers, stream);
}

int lean_decode_fused_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                             const int* desc, int n_cols, int tiles_per_worker,
                             int num_workers, const int* seg_ctx, const int* route,
                             const int* piece_start, const int* piece_count, int* arrivals,
                             float* o_p, float* m_p, float* l_p, float* o, float* lse,
                             int gq, int d, int tile, float scale, void* stream) {
  Args a = {q,           k_rows,      v_rows,   desc, seg_ctx, route,
            o_p,         m_p,         l_p,      piece_start, piece_count, arrivals,
            o,           lse,         n_cols,   tiles_per_worker, d, tile, scale};
  return launch<true>(dtype, a, gq, num_workers, stream);
}

}  // extern "C"
