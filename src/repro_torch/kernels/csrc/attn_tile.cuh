// Online-softmax tile updates shared by the port's attention kernels.
//
//   decode_scores,    the three phases of one decode update: gq query rows
//   decode_softmax,   of one segment against one K/V tile masked to a
//   decode_pv         runtime length;
//   tile_update       the three phases on a tile read from device memory
//                     (int8 tiles staged by cp.async first): K1, K2, K5 and
//                     K6 where their decode ring does not fit; on the ring
//                     (attn_decode_ring.cuh) they run ring::tile_update,
//                     the same arithmetic on the staged tile, which shares
//                     decode_softmax;
//   merge_piece       one step of the softmax re-scaling merge (paper
//                     section IV-A): K3 (lean_merge.cu); fold_pieces, the
//                     same step batched, K2's and K5's fix-ups.
//   rows_page_update  a block of kBlockRows query rows against one K/V tile
//                     or page, each row with its own range of visible keys
//                     (the chunk-causal mask, and with kWindow a sliding
//                     window's left edge), walked in sub-tiles when the
//                     page's float32 tile does not fit beside the block's
//                     state (rows_tile_update is one sub-tile): K4
//                     (lean_prefill.cu), K7 and K8 (flash_prefill.cu).
//
// The updates are LeanAttention's Algorithm 1, lines 20-25, with the
// arithmetic of the reference kernels (repro/kernels/lean_decode.py:74-114,
// lean_prefill.py:110-137):
//   s = (q . k) * scale, masked keys at NEG_INF
//   m_new = max(m, rowmax s); p = exp(s - m_new) (0 where masked)
//   l = exp(m - m_new) * l + sum p; acc = exp(m - m_new) * acc + p @ v
// Keys a row cannot see contribute nothing; a tile no row of the block can
// see leaves (acc, m, l) exactly as they were, so callers skip it.
// Everything is float32 in shared memory; K/V are read once per tile.
//
// int8 K/V (the reference's quantized bodies, the int8 page pools): the
// storage type is int8_t and each tile comes with the float32 scales of its
// pool row (ks for K, vs for V). An element is dequantized as float(x) * ks
// before it enters a product -- the reference widens the tile and multiplies
// it by its scale before QK^T and PV -- and everything after the load is the
// float path's arithmetic. int8 rows are read as 16-byte vectors: the
// decode tile_update copies the tile's K and V rows into shared memory with
// cp.async (every copy of the tile in flight at once), the decode ring with
// its bulk copies, and the row-block update widens 16 values per load. Rows
// must hold a multiple of 16 values.
//
// e4m3 K/V (the f8 pools): the storage type is __nv_fp8_e4m3 and there are
// no scales. The rows travel as int8 rows do -- 1-byte staging, 16-byte
// copies, the same alignment rule -- and an element is widened to float32
// as it is read (dequant is to_float). e4m3 -> float32 is exact, so a
// kernel on e4m3 rows gives the bits of its bf16 form on the rows widened
// to bf16 (also exact), NaN included.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr float kNegInf = -1e30f;  // finite mask value, as the reference
constexpr int kVec = 16;           // bytes of one int8 vector load

using e4m3 = __nv_fp8_e4m3;

template <typename T>
constexpr bool is_int8 = std::is_same<T, int8_t>::value;
template <typename T>
constexpr bool is_f8 = std::is_same<T, e4m3>::value;
// 1-byte rows (int8 with scales, e4m3 without): staged and read as 16-byte vectors
template <typename T>
constexpr bool is_byte = is_int8<T> || is_f8<T>;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(e4m3 x) { return static_cast<float>(x); }

// An element of a K/V tile as float32: int8 values times their row's scale
// (e4m3 values carry none).
template <typename T>
__device__ __forceinline__ float dequant(T x, float sc) {
  if constexpr (is_int8<T>)
    return to_float(x) * sc;
  else
    return to_float(x);
}

// 16 bytes global -> shared, asynchronously (cp.async.cg: L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

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

// One piece (op, mp, lp) folded into a running (acc, m, l), with the -inf
// guards of core/merge.py: a side whose max is -inf weighs 0 (the kernels'
// own partials use the finite -1e30, for which the guards change nothing).
__device__ __forceinline__ void merge_piece(float op, float mp, float lp, float& acc, float& m,
                                            float& l) {
  const float m_new = fmaxf(m, mp);
  const float a_old = (isinf(m) && m < 0.f) ? 0.f : expf(m - m_new);
  const float a_new = (isinf(mp) && mp < 0.f) ? 0.f : expf(mp - m_new);
  l = a_old * l + a_new * lp;
  acc = a_old * acc + a_new * op;
  m = m_new;
}

// The fix-ups of K2 (lean_decode.cu) and K5 (lean_cascade.cuh) fold a
// target's pieces kFold at a time: a thread owns W columns of one row (W =
// 4 where d allows, one float4 load a piece) and has the loads of kFold
// pieces in flight before it folds them, in piece order.
constexpr int kFold = 8;

// One piece folded into W columns of a row whose running max and sum are
// (m, l): merge_piece's arithmetic with its contraction written out -- l =
// fma(a_old, l, a_new * lp), acc = fma(a_old, acc, a_new * op), what
// merge_piece compiles to in a fold that loads one piece at a time -- so
// that the batched fold keeps that fold's bits (left to the compiler, the
// W columns' shared terms were contracted the other way round).
template <int W>
__device__ __forceinline__ void fold_piece(const float (&op)[W], float mp, float lp,
                                           float (&acc)[W], float& m, float& l) {
  const float m_new = fmaxf(m, mp);
  const float a_old = (isinf(m) && m < 0.f) ? 0.f : expf(m - m_new);
  const float a_new = (isinf(mp) && mp < 0.f) ? 0.f : expf(mp - m_new);
  l = fmaf(a_old, l, __fmul_rn(a_new, lp));
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = fmaf(a_old, acc[w], __fmul_rn(a_new, op[w]));
  m = m_new;
}

// Pieces 0 .. count-1 folded in order into columns [c, c + W) of a row and
// its (m, l) (acc 0, m kNegInf, l 0 to start): piece k's partial row is
// row_of(k) of the float32 scratch o_p (row stride d), m_p and l_p. Other
// CTAs wrote the scratch, so it is read with ld.global.cg (L2, not L1).
template <int W, typename RowOf>
__device__ __forceinline__ void fold_pieces(const float* o_p, const float* m_p,
                                            const float* l_p, int d, int c, int count,
                                            RowOf row_of, float (&acc)[W], float& m, float& l) {
  for (int k0 = 0; k0 < count; k0 += kFold) {
    float op[kFold][W], mp[kFold], lp[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      if (k0 + u >= count) break;
      const size_t pr = row_of(k0 + u);
      if constexpr (W == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(o_p + pr * d + c));
        op[u][0] = v.x;
        op[u][1] = v.y;
        op[u][2] = v.z;
        op[u][3] = v.w;
      } else {
        op[u][0] = __ldcg(o_p + pr * d + c);
      }
      mp[u] = __ldcg(m_p + pr);
      lp[u] = __ldcg(l_p + pr);
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      if (k0 + u >= count) break;
      fold_piece<W>(op[u], mp[u], lp[u], acc, m, l);
    }
  }
}

// Row buckets of the decode tile update: a segment of n query rows runs
// the instantiation for the smallest bucket >= n (0: more than 64 rows).
__host__ __device__ inline int row_bucket(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 0;
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

// Bytes of the 1-byte (int8, e4m3) staging area ahead of the float state:
// one tile's K and V rows (none for float storage). A multiple of 16, so
// the floats after it stay aligned.
template <typename T>
__host__ __device__ inline size_t stage_bytes(int d, int tile) {
  return is_byte<T> ? (size_t)2 * tile * d : 0;
}

// Zero the accumulator and reset the running max and sum of the QB rows
// (NT threads).
template <int QB, int NT = kThreads>
__device__ void reset_decode_rows(const Smem& s, int d) {
  for (int e = threadIdx.x; e < QB * d; e += NT) s.acc[e] = 0.f;
  for (int r = threadIdx.x; r < QB; r += NT) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
}

// The segment's `rows` query rows (row stride d) into s.q; rows up to QB
// are zero, and their results are never written.
template <typename T, int QB, int NT = kThreads>
__device__ __forceinline__ void load_decode_q(const T* __restrict__ q_rows, int rows,
                                              const Smem& s, int d) {
  for (int e = threadIdx.x; e < rows * d; e += NT) s.q[e] = to_float(q_rows[e]);
  for (int e = rows * d + threadIdx.x; e < QB * d; e += NT) s.q[e] = 0.f;
}

// StorePartials: the un-scaled (acc, m, l) of the first `rows` rows.
template <int NT = kThreads>
__device__ __forceinline__ void flush_rows(const Smem& s, int rows, int d, float* o_dst,
                                           float* m_dst, float* l_dst) {
  for (int e = threadIdx.x; e < rows * d; e += NT) o_dst[e] = s.acc[e];
  for (int r = threadIdx.x; r < rows; r += NT) {
    m_dst[r] = s.m[r];
    l_dst[r] = s.l[r];
  }
}

// The three phases of one decode update of the GQ rows against a tile's
// first vlen keys: A writes the scores, B the running max, probabilities
// and exp-sum, C the accumulator. The caller syncs the threads between
// phases. K and V rows may lie in device memory or in a shared-memory copy
// of the tile (int8 staging): the arithmetic is the same. No phase's sums
// depend on the CTA's width -- each key's dot is one warp's, over d in
// lane-stride order and then warp_sum; each row's max and exp-sum one
// warp's; each output column's PV one thread's, over the keys in order --
// which is what lets the decode ring's consumers (ring::tile_update) give
// the same bits.

// Phase A: one warp per key, lanes stride over d (coalesced row reads); KB
// keys in flight per warp.
template <typename T, int GQ>
__device__ __forceinline__ void decode_scores(const T* __restrict__ kp, int vlen, const Smem& s,
                                              int d, int tile, float scale, float ks) {
  constexpr int NW = kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int KB = GQ <= 4 ? 4 : GQ <= 16 ? 2 : 1;
  for (int j0 = warp; j0 < vlen; j0 += KB * NW) {
    const T* krow[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int j = j0 + u * NW;
      krow[u] = kp + (size_t)(j < vlen ? j : j0) * d;
    }
    float part[KB][GQ];
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int r = 0; r < GQ; ++r) part[u][r] = 0.f;
    for (int c = lane; c < d; c += 32) {
      float kv[KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) kv[u] = dequant(krow[u][c], ks);
#pragma unroll
      for (int u = 0; u < KB; ++u)
#pragma unroll
        for (int r = 0; r < GQ; ++r) part[u][r] = fmaf(s.q[r * d + c], kv[u], part[u][r]);
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int j = j0 + u * NW;
#pragma unroll
      for (int r = 0; r < GQ; ++r) {
        const float dot = warp_sum(part[u][r]);
        if (lane == 0 && j < vlen) s.p[r * tile + j] = dot * scale;
      }
    }
  }
}

// Phase B: one warp per query row -- running max, probabilities, exp-sum.
template <int GQ, int NT>
__device__ __forceinline__ void decode_softmax(int vlen, const Smem& s, int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < GQ; r += NT / 32) {
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
}

// Phase C: one thread per output column, V rows read coalesced, CB rows in
// flight per thread.
template <typename T, int GQ>
__device__ __forceinline__ void decode_pv(const T* __restrict__ vp, int vlen, const Smem& s,
                                          int d, int tile, float vs) {
  constexpr int CB = 16;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float* pr = s.p;
    float pv[GQ];
#pragma unroll
    for (int r = 0; r < GQ; ++r) pv[r] = 0.f;
    int j = 0;
    for (; j + CB <= vlen; j += CB) {
      float vv[CB];
#pragma unroll
      for (int u = 0; u < CB; ++u) vv[u] = dequant(vp[(size_t)(j + u) * d + c], vs);
#pragma unroll
      for (int u = 0; u < CB; ++u)
#pragma unroll
        for (int r = 0; r < GQ; ++r) pv[r] = fmaf(pr[r * tile + j + u], vv[u], pv[r]);
    }
    for (; j < vlen; ++j) {
      const float vv = dequant(vp[(size_t)j * d + c], vs);
#pragma unroll
      for (int r = 0; r < GQ; ++r) pv[r] = fmaf(pr[r * tile + j], vv, pv[r]);
    }
    float* acc = s.acc + c;
#pragma unroll
    for (int r = 0; r < GQ; ++r) acc[r * d] = s.alpha[r] * acc[r * d] + pv[r];
  }
}

// One decode update of the GQ rows against the tile's first vlen keys.
// Keys past vlen are neither loaded nor accumulated (their p is 0).
// kThreads threads; caller syncs before (q/acc ready), this syncs after.
// The tile is read from device memory inside the phases: only the loads
// each thread keeps in flight hide the memory latency (phase A keeps KB
// keys per warp, phase C CB V rows per thread). int8 tiles (ks, vs their
// scales) first land in `stage` (stage_bytes<T>), then both phases read
// them there.
template <typename T, int GQ>
__device__ void tile_update(const T* __restrict__ k_tile, const T* __restrict__ v_tile,
                            int vlen, const Smem& s, int d, int tile, float scale,
                            float ks = 1.f, float vs = 1.f, int8_t* stage = nullptr) {
  const T* kp = k_tile;
  const T* vp = v_tile;
  if constexpr (is_byte<T>) {
    const int nvec = vlen * d / kVec;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      cp_async16(stage + i * kVec, k_tile + i * kVec);
      cp_async16(stage + (size_t)tile * d + i * kVec, v_tile + i * kVec);
    }
    cp_async_wait_all();
    __syncthreads();
    kp = reinterpret_cast<const T*>(stage);
    vp = reinterpret_cast<const T*>(stage + (size_t)tile * d);
  }
  decode_scores<T, GQ>(kp, vlen, s, d, tile, scale, ks);
  __syncthreads();
  decode_softmax<GQ, kThreads>(vlen, s, tile);
  __syncthreads();
  decode_pv<T, GQ>(vp, vlen, s, d, tile, vs);
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
  int* lim;      // (kBlockRows)          keys of this tile each row sees: [lo, lim)
  int* lo;       // (kBlockRows)          read only by rows_tile_update<T, true>
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
  s.lo = s.lim + kBlockRows;
  return s;
}

inline size_t row_smem_bytes(int d, int tile) {
  return sizeof(float) * ((size_t)2 * kBlockRows * (d + 1) + (size_t)tile * (d + 1) +
                          (size_t)kBlockRows * (tile + 1) + 5 * (size_t)kBlockRows);
}

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a CTA may use on Hopper

// Keys per sub-tile of rows_page_update: the whole tile where its shared
// memory fits -- a page that fits runs one update, as it always did -- else
// the largest of 128, 64, 32, 16 or 8 keys (at most the tile) that fits;
// 0 if none does. (lean_prefill.py's row_sub_tile is the same rule.)
inline int row_sub_tile(int d, int tile) {
  if (row_smem_bytes(d, tile) <= kSmemLimit) return tile;
  for (int sub = tile < 128 ? tile : 128; sub >= 8; sub /= 2)
    if (row_smem_bytes(d, sub) <= kSmemLimit) return sub;
  return 0;
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

// n K or V rows (row stride d) into s.kv as float32, times `sc` if int8
// (1-byte rows: 16 values a load).
template <typename T>
__device__ void load_kv_rows(const T* __restrict__ src, int n, float* dst, int d, float sc) {
  const int ld = d + 1;
  if constexpr (is_byte<T>) {
    for (int e = threadIdx.x; e < n * d / kVec; e += kRowThreads) {
      const int j = e * kVec / d, c = e * kVec - j * d;
      const int4 raw = *reinterpret_cast<const int4*>(src + (size_t)e * kVec);
      const T* b = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[j * ld + c + u] = dequant(b[u], sc);
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += kRowThreads) {
      const int j = e / d, c = e - j * d;
      dst[j * ld + c] = to_float(src[(size_t)j * d + c]);
    }
  }
}

// One update of the block's rows against the n keys [k0, k0 + n) of a
// page (k_tile and v_tile point at key k0), n <= sub, the sub-tile width the
// shared memory was carved for. Row r sees the page's keys [0, s.lim[r]) --
// with kWindow, [s.lo[r], s.lim[r]); a row that sees none of the n keys is
// left as it was. Only the n K and V rows are read. Caller syncs before (q,
// acc, m, l, lim and lo ready); this syncs after.
template <typename T, bool kWindow = false>
__device__ void rows_tile_update(const T* __restrict__ k_tile, const T* __restrict__ v_tile,
                                 int n, int k0, const RowSmem& s, int d, int sub, float scale,
                                 float ks, float vs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid / kGridDim, tc = tid % kGridDim;
  const int ld = d + 1, ldp = sub + 1;

  load_kv_rows<T>(k_tile, n, s.kv, d, ks);
  __syncthreads();

  // phase A: scores of the 4 x 8 (row, key) tile of each thread
  for (int j0 = 0; j0 < n; j0 += kPass) {
    float acc[kRowsPerThread][kColsPerThread];
    bool ok[kColsPerThread];
    int koff[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int j = j0 + tc + kGridDim * i;
      ok[i] = j < n;
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
  load_kv_rows<T>(v_tile, n, s.kv, d, vs);

  // phase B: one warp per row -- running max, probabilities, exp-sum
  for (int r = warp; r < kBlockRows; r += kRowWarps) {
    float* prow = s.p + r * ldp;
    const int lim = min(s.lim[r] - k0, n);
    const int lo = kWindow ? max(s.lo[r] - k0, 0) : 0;
    float mx = kNegInf;
    for (int j = lo + lane; j < lim; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = j >= lo && j < lim ? expf(prow[j] - m_new) : 0.f;
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
    for (int j = 0; j < n; ++j) {
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

// The block's rows against keys [0, jmax) of one page or tile, where jmax =
// max s.lim[r] > 0 and row r sees the keys [0, s.lim[r]) (with kWindow,
// [s.lo[r], s.lim[r])), in sub-tiles of `sub` keys (row_sub_tile): one
// rows_tile_update per sub-tile, in key order, as the online softmax
// walks tiles. With sub >= jmax it is a single update over the whole
// page. int8 pages take their row's scales ks, vs.
template <typename T, bool kWindow = false>
__device__ void rows_page_update(const T* __restrict__ k_page, const T* __restrict__ v_page,
                                 int jmax, const RowSmem& s, int d, int sub, float scale,
                                 float ks = 1.f, float vs = 1.f) {
  for (int k0 = 0; k0 < jmax; k0 += sub)
    rows_tile_update<T, kWindow>(k_page + (size_t)k0 * d, v_page + (size_t)k0 * d,
                                 min(sub, jmax - k0), k0, s, d, sub, scale, ks, vs);
}

}  // namespace attn
