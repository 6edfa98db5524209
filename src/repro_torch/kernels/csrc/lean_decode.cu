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
// LeanTile online-softmax update (tile_update below, shared by K1 and K2)
// of the segment's gq query rows against one tile x d K/V tile read from
// pool row route[i], masked to the runtime length
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // finite mask value, as the reference

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Smem {
  float* q;      // (GQ, d)      query rows of the current segment
  float* acc;    // (GQ, d)      running un-scaled output
  float* p;      // (GQ, tile)   scores, then probabilities
  float* m;      // (GQ)         running row max
  float* l;      // (GQ)         running exp-sum
  float* alpha;  // (GQ)         rescale of this update
};

template <int GQ>
__device__ Smem carve_smem(float* base, int d, int tile) {
  Smem s;
  s.q = base;
  s.acc = s.q + GQ * d;
  s.p = s.acc + GQ * d;
  s.m = s.p + GQ * tile;
  s.l = s.m + GQ;
  s.alpha = s.l + GQ;
  return s;
}

// One LeanTile online-softmax update (Algorithm 1 lines 20-25), the same
// arithmetic as repro/kernels/lean_decode.py:74-114:
//   s = (q . k) * scale, masked to vlen with NEG_INF
//   m_new = max(m, rowmax s); p = exp(s - m_new) (0 where masked)
//   l = exp(m - m_new) * l + sum p; acc = exp(m - m_new) * acc + p @ v
// Keys past vlen are neither loaded nor accumulated (their p is 0).
// Caller syncs before (q/acc ready) and after (acc/m/l final).
template <typename T, int GQ>
__device__ void tile_update(const T* __restrict__ k_tile, const T* __restrict__ v_tile,
                            int vlen, const Smem& s, int d, int tile, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // phase A: one warp per key, lanes stride over d (coalesced row reads)
  for (int j = warp; j < vlen; j += kWarps) {
    const T* krow = k_tile + (size_t)j * d;
    float part[GQ];
#pragma unroll
    for (int r = 0; r < GQ; ++r) part[r] = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float kv = to_float(krow[c]);
#pragma unroll
      for (int r = 0; r < GQ; ++r) part[r] = fmaf(s.q[r * d + c], kv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < GQ; ++r) {
      const float dot = warp_sum(part[r]);
      if (lane == 0) s.p[r * tile + j] = dot * scale;
    }
  }
  __syncthreads();

  // phase B: one warp per query row -- running max, probabilities, exp-sum
  for (int r = warp; r < GQ; r += kWarps) {
    float* prow = s.p + r * tile;
    float mx = kNegInf;
    for (int j = lane; j < vlen; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < vlen; j += 32) {
      const float e = expf(prow[j] - m_new);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      s.alpha[r] = a;
      s.l[r] = a * s.l[r] + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();

  // phase C: one thread per output column, V rows read coalesced
  for (int c = tid; c < d; c += kThreads) {
    float pv[GQ];
#pragma unroll
    for (int r = 0; r < GQ; ++r) pv[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < vlen; ++j) {
      const float vv = to_float(v_tile[(size_t)j * d + c]);
#pragma unroll
      for (int r = 0; r < GQ; ++r) pv[r] = fmaf(s.p[r * tile + j], vv, pv[r]);
    }
#pragma unroll
    for (int r = 0; r < GQ; ++r) s.acc[r * d + c] = s.alpha[r] * s.acc[r * d + c] + pv[r];
  }
  __syncthreads();
}

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
  const Smem s = carve_smem<GQ>(smem_raw, a.d, a.tile);
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
    for (int e = threadIdx.x; e < GQ * d; e += kThreads) s.q[e] = to_float(qs[e]);
    const int vlen = min(max(a.seg_ctx[seg] - tile_idx * tile, 0), tile);
    const size_t row = (size_t)a.route[i];
    __syncthreads();

    tile_update<T, GQ>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
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

size_t smem_bytes(int gq, int d, int tile) {
  return sizeof(float) * ((size_t)2 * gq * d + (size_t)gq * tile + 3 * (size_t)gq);
}

template <typename T, int GQ, bool FUSED>
cudaError_t launch_typed(const Args& a, int num_workers, cudaStream_t stream) {
  auto kernel = lean_decode_kernel<T, GQ, FUSED>;
  const size_t smem = smem_bytes(GQ, a.d, a.tile);
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
