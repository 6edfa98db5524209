// Online-softmax tile updates shared by the port's attention kernels.
//
//   tile_update       gq query rows of one decode segment against one K/V
//                     tile masked to a runtime length: K1, K2
//                     (lean_decode.cu) and K6 (flash_decode.cu).
//   rows_tile_update  a block of kBlockRows query rows against one K/V tile,
//                     each row with its own count of visible keys (the
//                     chunk-causal mask): K4 (lean_prefill.cu) and K8
//                     (flash_prefill.cu).
//
// Both are the update of LeanAttention's Algorithm 1, lines 20-25, with the
// arithmetic of the reference kernels (repro/kernels/lean_decode.py:74-114,
// lean_prefill.py:110-137):
//   s = (q . k) * scale, masked keys at NEG_INF
//   m_new = max(m, rowmax s); p = exp(s - m_new) (0 where masked)
//   l = exp(m - m_new) * l + sum p; acc = exp(m - m_new) * acc + p @ v
// Keys a row cannot see contribute nothing; a tile no row of the block can
// see leaves (acc, m, l) exactly as they were, so callers skip it.
// Everything is float32 in shared memory; K/V are read once per tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;  // finite mask value, as the reference

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

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

// ------------------------------------------------------------------ decode
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

inline size_t smem_bytes(int gq, int d, int tile) {
  return sizeof(float) * ((size_t)2 * gq * d + (size_t)gq * tile + 3 * (size_t)gq);
}

// One decode update of the GQ rows against the tile's first vlen keys.
// Keys past vlen are neither loaded nor accumulated (their p is 0).
// kThreads threads; caller syncs before (q/acc ready), this syncs after.
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

// --------------------------------------------------------------- row blocks
// A CTA of kRowThreads threads owns kBlockRows query rows. The threads form
// a 16 x 16 grid: thread (tr, tc) computes rows tr*4 .. tr*4+3 against keys
// (phase A) or output columns (phase C) tc, tc+16, ..., tc+112 of a 128-wide
// pass -- a 4 x 8 register tile, 12 shared loads per 32 FMAs. Shared rows
// are padded by one float so that the 16 columns of a pass fall on 16
// different banks.
constexpr int kRowThreads = 256;
constexpr int kBlockRows = 64;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kGridDim = 16;        // tr and tc each run over 16
constexpr int kRowsPerThread = kBlockRows / kGridDim;   // 4
constexpr int kColsPerThread = 8;   // 16 x 8 = 128 keys / columns per pass
constexpr int kPass = kGridDim * kColsPerThread;

struct RowSmem {
  float* q;      // (kBlockRows, d + 1)   query rows of the block
  float* acc;    // (kBlockRows, d + 1)   running un-scaled output
  float* kv;     // (tile, d + 1)         the tile's K, then its V
  float* p;      // (kBlockRows, tile + 1) scores, then probabilities
  float* m;      // (kBlockRows)
  float* l;      // (kBlockRows)
  float* alpha;  // (kBlockRows)
  int* lim;      // (kBlockRows)          keys of this tile each row sees
};

__device__ inline RowSmem carve_row_smem(float* base, int d, int tile) {
  RowSmem s;
  const int ld = d + 1;
  s.q = base;
  s.acc = s.q + kBlockRows * ld;
  s.kv = s.acc + kBlockRows * ld;
  s.p = s.kv + (size_t)tile * ld;
  s.m = s.p + kBlockRows * (tile + 1);
  s.l = s.m + kBlockRows;
  s.alpha = s.l + kBlockRows;
  s.lim = reinterpret_cast<int*>(s.alpha + kBlockRows);
  return s;
}

inline size_t row_smem_bytes(int d, int tile) {
  return sizeof(float) * ((size_t)2 * kBlockRows * (d + 1) + (size_t)tile * (d + 1) +
                          (size_t)kBlockRows * (tile + 1) + 4 * (size_t)kBlockRows);
}

// Zero the accumulator and reset the running max and sum of every row.
__device__ inline void reset_rows(const RowSmem& s, int d) {
  for (int e = threadIdx.x; e < kBlockRows * d; e += kRowThreads) {
    const int r = e / d, c = e - r * d;
    s.acc[r * (d + 1) + c] = 0.f;
  }
  for (int r = threadIdx.x; r < kBlockRows; r += kRowThreads) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
}

// Rows [0, nrows) of q_rows (row stride d) into s.q; the rest are zero.
template <typename T>
__device__ void load_rows(const T* __restrict__ q_rows, int nrows, const RowSmem& s, int d) {
  for (int e = threadIdx.x; e < kBlockRows * d; e += kRowThreads) {
    const int r = e / d, c = e - r * d;
    s.q[r * (d + 1) + c] = r < nrows ? to_float(q_rows[(size_t)r * d + c]) : 0.f;
  }
}

// One update of the block's rows against keys [0, jmax) of a tile, where
// jmax = max s.lim[r] > 0 and row r sees keys [0, s.lim[r]). Only the
// first jmax K and V rows are read. Caller syncs before (q, acc, m, l and
// lim ready); this syncs after.
template <typename T>
__device__ void rows_tile_update(const T* __restrict__ k_tile, const T* __restrict__ v_tile,
                                 int jmax, const RowSmem& s, int d, int tile, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid / kGridDim, tc = tid % kGridDim;
  const int ld = d + 1, ldp = tile + 1;

  for (int e = tid; e < jmax * d; e += kRowThreads) {
    const int j = e / d, c = e - j * d;
    s.kv[j * ld + c] = to_float(k_tile[(size_t)j * d + c]);
  }
  __syncthreads();

  // phase A: scores of the 4 x 8 (row, key) tile of each thread
  for (int j0 = 0; j0 < jmax; j0 += kPass) {
    float acc[kRowsPerThread][kColsPerThread];
    bool ok[kColsPerThread];
    int koff[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int j = j0 + tc + kGridDim * i;
      ok[i] = j < jmax;
      koff[i] = ok[i] ? j * ld : 0;
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) acc[rr][i] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) qv[rr] = s.q[(tr * kRowsPerThread + rr) * ld + c];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) kv[i] = ok[i] ? s.kv[koff[i] + c] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
        for (int i = 0; i < kColsPerThread; ++i) acc[rr][i] = fmaf(qv[rr], kv[i], acc[rr][i]);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i)
        if (ok[i]) s.p[(tr * kRowsPerThread + rr) * ldp + j0 + tc + kGridDim * i] = acc[rr][i] * scale;
  }
  __syncthreads();

  // V replaces K in shared memory while the warps run phase B
  for (int e = tid; e < jmax * d; e += kRowThreads) {
    const int j = e / d, c = e - j * d;
    s.kv[j * ld + c] = to_float(v_tile[(size_t)j * d + c]);
  }

  // phase B: one warp per row -- running max, probabilities, exp-sum
  for (int r = warp; r < kBlockRows; r += kRowWarps) {
    float* prow = s.p + r * ldp;
    const int lim = s.lim[r];
    float mx = kNegInf;
    for (int j = lane; j < lim; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < jmax; j += 32) {
      const float e = j < lim ? expf(prow[j] - m_new) : 0.f;
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

  // phase C: acc = alpha * acc + p @ v on the 4 x 8 (row, column) tile
  for (int c0 = 0; c0 < d; c0 += kPass) {
    float o[kRowsPerThread][kColsPerThread];
    bool ok[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      ok[i] = c0 + tc + kGridDim * i < d;
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) o[rr][i] = 0.f;
    }
    for (int j = 0; j < jmax; ++j) {
      float pv[kRowsPerThread], vv[kColsPerThread];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) pv[rr] = s.p[(tr * kRowsPerThread + rr) * ldp + j];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i)
        vv[i] = ok[i] ? s.kv[j * ld + c0 + tc + kGridDim * i] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
        for (int i = 0; i < kColsPerThread; ++i) o[rr][i] = fmaf(pv[rr], vv[i], o[rr][i]);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      const int r = tr * kRowsPerThread + rr;
      const float a = s.alpha[r];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i)
        if (ok[i]) {
          float* dst = s.acc + r * ld + c0 + tc + kGridDim * i;
          *dst = a * *dst + o[rr][i];
        }
    }
  }
  __syncthreads();
}

}  // namespace attn
