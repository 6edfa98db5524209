// Stream-K chunked prefill on the tensor cores for Hopper: K4, K4-int8 and
// K4-f8, the per-piece partials and their merge in one launch.
//
// Replaces the Pallas TPU kernel of the reference:
//   K4  repro/kernels/lean_prefill.py:51  _lean_prefill_kernel
//       (int8 body :102, driven by lean_prefill_chunk_partials :140)
// together with the decode merge that finishes its partials there
// (segment_merge), for bf16 queries over bf16, int8 or e4m3 pages.
//
// The function. A pack of N prompt chunks is a decode workload with taller
// segments: segment (chunk, kv_head) holds rows = g * C query rows,
// flattened (g, C) chunk-minor, and row r sees the keys kv_start + j of
// each descriptor column with j < vlen = clamp(ctx[seg] - kv_start, 0,
// page) and kv_start + j <= qstart[seg] + r % C. The output is o (S, rows,
// d) in bf16, q's own layout.
//
// What bounds it on this card: operations. At the main path's shapes (two
// 256-token chunks at offsets 2048 and 37, Hq 32, Hkv 8, d 128) the pack
// does about 9.8 GFLOP against 19 MB of q, K/V and o, far above the bf16
// ridge point, so the tensor cores are the resource -- the same work as
// K8's (flash_prefill.cu), on the stream-K schedule instead of K8's fixed
// grid.
//
// Design: attn_tc.cuh's row block (a TMA producer warpgroup, two wgmma
// consumer warpgroups of 64 rows, key tiles of 128 in a 2-stage ring, P
// through PV as two bf16 halves) with a stream-K walk. The grid is
// (stream-K worker, row block of 128 rows); rows are independent in online
// softmax, so the decode schedule serves every row block. (One CTA a
// worker that walks its columns once a row block, the ring running on, is
// slower: its passes, each with its Q reload and flush, run one after
// another on one SM.) Each CTA walks its worker's descriptor columns; a
// column is one page route[i], one TMA box a page (a page above 128 keys
// in sub-tiles of 128). A column no row of the CTA sees is not loaded, but
// its first (reset) and last (flush) are honoured. The producer loads Q
// again when the segment changes, after the new tile's K and V and after
// every consumer warp has said it is done with the old Q (the "Q free"
// barrier). On a piece's last column the consumers:
//   * write o / max(l, 1e-30) in bf16 straight to the output when the
//     segment has one piece;
//   * otherwise write the un-normalised piece (o, m in natural-log units,
//     l) to float32 scratch, fence, and bump the arrival counter of
//     (segment, row block); the CTA whose arrival completes it folds that
//     row block's pieces in piece order with attn::merge_piece's
//     arithmetic (K2's fix-up, lean_decode.cu), several rows' loads in
//     flight a thread, and writes the bf16 output. The order of the sums
//     does not depend on which CTA arrives last, and nobody waits for
//     anybody, so the result is the same bits on every run and no
//     co-residency is needed.
//
// int8 pages (dtype code 2): bf16 q, int8 K/V rows and a float32 scale per
// pool row. An int8 value is exact in bf16, so the scales stay outside the
// products: TMA brings the int8 page into an int8 staging ring (2 stages),
// the producer warpgroup converts it to the bf16 swizzled tile wgmma reads,
// and the consumers multiply the scores by the page's K scale (before the
// mask and the base-2 scale) and P by its V scale (before the bf16 split);
// l sums the unscaled p. At d 128 that is Q 32 KB + K/V rings 128 KB +
// staging 64 KB + alignment = 230,400 bytes of the 232,448 a CTA may have.
//
// f8 pages (dtype code 3): bf16 q and e4m3 K/V rows, no scales. They take
// int8's staging ring and producer; the conversion widens e4m3 to bf16
// (exact), and the consumers run the bf16 tile update unchanged, so the
// result is the bf16 kernel's bits on the pool widened to bf16.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t,
// or attn_tc::kEncodeError + the CUresult of a failed tensor-map encoding.

#include "attn_tc.cuh"
#include "attn_tile.cuh"

#include <limits.h>

#include <algorithm>

namespace {

using attn_tc::kKeys;
using attn_tc::kPanelBytes;
using attn_tc::kRows;
using attn_tc::kStages;
using attn_tc::kWgRows;

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };

// barriers: Q full, K full [2], V full [2], stage empty [2], Q free,
// 1-byte staging full [2]
enum { BAR_Q = 0, BAR_K = 1, BAR_V = 3, BAR_EMPTY = 5, BAR_QFREE = 7, BAR_STAGE = 8 };
constexpr int kNumBars = 10;
constexpr int kFlushBar = 3;      // named barrier of the 256 consumer threads
constexpr int kConvertBar = 4;    // named barrier of the 128 producer threads

// K/V storage: bf16 pages go straight into the bf16 ring; int8 (with row
// scales) and e4m3 pages are staged and converted to it.
enum { KV_BF16 = 0, KV_INT8 = 1, KV_F8 = 2 };

struct Args {
  const int* desc;          // (7, n_cols)
  const int* seg_ctx;       // (S,) visible KV length of each segment
  const int* seg_qstart;    // (S,) absolute position of each segment's row 0
  const int* route;         // (n_cols,) pool row per column
  const float* k_scales;    // (R,) int8 rows only
  const float* v_scales;
  const int* piece_start;   // (S,)
  const int* piece_count;   // (S,)
  int* arrivals;            // (S, num_rb), zero at launch; re-zeroed by the last arriver
  float* o_p;               // (P+1, rows, d) scratch of multi-piece segments
  float* m_p;               // (P+1, rows)
  float* l_p;
  __nv_bfloat16* out;       // (S, rows, d)
  int n_cols, tiles_per_worker, rows, chunk_cap, page, num_rb;
  float scale_log2;         // scale * log2(e)
};

// Descriptor column i as the CTA sees it: keys [kv_start, kv_start + vlen)
// exist, and some row of the CTA (positions up to pmax) sees the first jmax
// of them, walked in nsub sub-tiles of 128 keys.
struct Column {
  int seg, kv_start, piece, vlen, jmax, nsub;
  bool valid, first, last;
};

__device__ __forceinline__ Column column(const Args& a, int i, int pmax) {
  Column c;
  const int N = a.n_cols;
  c.valid = a.desc[DESC_VALID * N + i] == OP_PARTIAL;
  c.seg = c.kv_start = c.piece = c.vlen = c.jmax = c.nsub = 0;
  c.first = c.last = false;
  if (!c.valid) return c;
  c.seg = a.desc[DESC_SEG * N + i];
  c.kv_start = a.desc[DESC_TILE * N + i] * a.page;
  c.piece = a.desc[DESC_PIECE * N + i];
  c.first = a.desc[DESC_FIRST * N + i] != 0;
  c.last = a.desc[DESC_LAST * N + i] != 0;
  c.vlen = min(max(a.seg_ctx[c.seg] - c.kv_start, 0), a.page);
  c.jmax = min(c.vlen, max(a.seg_qstart[c.seg] + pmax + 1 - c.kv_start, 0));
  c.nsub = (c.jmax + kKeys - 1) / kKeys;
  return c;
}

// The next key tile of the walk at or after (column t, sub-tile sub):
// false when the worker's columns are done.
__device__ __forceinline__ bool next_tile(const Args& a, int worker, int pmax, int& t, int& sub,
                                          Column& c) {
  for (; t < a.tiles_per_worker; ++t, sub = 0) {
    c = column(a, worker * a.tiles_per_worker + t, pmax);
    if (sub < c.nsub) return true;
  }
  return false;
}

template <int D>
__device__ __forceinline__ void load_q(const Args& a, int seg, int row0, uint32_t q_s,
                                       uint32_t bar, const CUtensorMap* qmap) {
  attn_tc::mbar_expect_tx(bar, (D / 64) * kPanelBytes);   // rows past `rows` arrive as zeros
  for (int p = 0; p < D / 64; ++p)
    attn_tc::tma_load_3d(q_s + p * kPanelBytes, qmap, bar, p * 64, row0, seg);
}

// ------------------------------------------------------------- producers
// bf16 pages: one thread issues every copy straight into the ring. A
// tile's K and V go out before a new Q, which waits until every consumer
// warp is done with the old one.
template <int D>
__device__ __forceinline__ void produce_bf16(const Args& a, int worker, int row0, int pmax,
                                             uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                             uint32_t bar0, const CUtensorMap* qmap,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap) {
  constexpr uint32_t kTile = (D / 64) * kPanelBytes;
  const int box = min(a.page, kKeys);
  const uint32_t bytes = box * 128 * (D / 64);   // rows past the page arrive as zeros
  int t = 0, sub = 0, it = 0, qn = 0, q_seg = -1;
  Column c;
  for (; next_tile(a, worker, pmax, t, sub, c); ++sub, ++it) {
    const int s = it % kStages;
    if (it >= kStages) attn_tc::mbar_wait(bar0 + 8 * (BAR_EMPTY + s), ((it / kStages) - 1) & 1);
    const int row = a.route[worker * a.tiles_per_worker + t];
    const uint32_t kbar = bar0 + 8 * (BAR_K + s), vbar = bar0 + 8 * (BAR_V + s);
    attn_tc::mbar_expect_tx(kbar, bytes);
    attn_tc::mbar_expect_tx(vbar, bytes);
    for (int p = 0; p < D / 64; ++p) {
      attn_tc::tma_load_3d(k_s + s * kTile + p * kPanelBytes, kmap, kbar, p * 64, sub * kKeys,
                           row);
      attn_tc::tma_load_3d(v_s + s * kTile + p * kPanelBytes, vmap, vbar, p * 64, sub * kKeys,
                           row);
    }
    if (c.seg != q_seg) {
      if (qn > 0) attn_tc::mbar_wait(bar0 + 8 * BAR_QFREE, (qn - 1) & 1);
      load_q<D>(a, c.seg, row0, q_s, bar0 + 8 * BAR_Q, qmap);
      ++qn;
      q_seg = c.seg;
    }
  }
}

// int8 and e4m3 pages: thread 0 issues the copies of the 1-byte tiles into
// the staging ring (two tiles ahead) and Q; the whole warpgroup converts
// each staged tile into the bf16 ring and then marks its K and V full.
template <int D, int KV>
__device__ __forceinline__ void produce_staged(const Args& a, int worker, int row0, int pmax,
                                             uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                             uint32_t st_s, uint32_t bar0, const CUtensorMap* qmap,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap) {
  constexpr uint32_t kTile = (D / 64) * kPanelBytes;
  constexpr uint32_t kStTile = kKeys * D;   // one 1-byte tile
  const int ptid = threadIdx.x;
  const int box = min(a.page, kKeys);
  int at = 0, asub = 0, issued = 0;   // thread 0's issue cursor
  auto issue = [&]() {
    Column c;
    if (!next_tile(a, worker, pmax, at, asub, c)) return;
    const int j = issued % kStages, row = a.route[worker * a.tiles_per_worker + at];
    const uint32_t bar = bar0 + 8 * (BAR_STAGE + j), dst = st_s + j * 2 * kStTile;
    attn_tc::mbar_expect_tx(bar, 2 * box * D);
    attn_tc::tma_load_3d(dst, kmap, bar, 0, asub * kKeys, row);
    attn_tc::tma_load_3d(dst + kStTile, vmap, bar, 0, asub * kKeys, row);
    ++asub;
    ++issued;
  };
  if (ptid == 0) {
    issue();
    issue();
  }
  int t = 0, sub = 0, it = 0, qn = 0, q_seg = -1;
  Column c;
  for (; next_tile(a, worker, pmax, t, sub, c); ++sub, ++it) {
    const int s = it % kStages;
    attn_tc::mbar_wait(bar0 + 8 * (BAR_STAGE + s), (it / kStages) & 1);
    if (it >= kStages) attn_tc::mbar_wait(bar0 + 8 * (BAR_EMPTY + s), ((it / kStages) - 1) & 1);
    const uint32_t src = st_s + s * 2 * kStTile;
    attn_tc::convert_tile<D, KV == KV_F8>(src, k_s + s * kTile, box, ptid);
    attn_tc::convert_tile<D, KV == KV_F8>(src + kStTile, v_s + s * kTile, box, ptid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(kConvertBar) : "memory");
    if (ptid == 0) {
      attn_tc::mbar_arrive(bar0 + 8 * (BAR_K + s));
      attn_tc::mbar_arrive(bar0 + 8 * (BAR_V + s));
      issue();   // staging stage s is free again
    }
    if (c.seg != q_seg) {
      if (ptid == 0) {
        if (qn > 0) attn_tc::mbar_wait(bar0 + 8 * BAR_QFREE, (qn - 1) & 1);
        load_q<D>(a, c.seg, row0, q_s, bar0 + 8 * BAR_Q, qmap);
      }
      ++qn;
      q_seg = c.seg;
    }
  }
}

// -------------------------------------------------------------- consumer
// The fix-up of (segment, row block) by its last CTA: fold pieces [start,
// start + count) in piece order with attn::merge_piece's arithmetic and
// write o / max(l, 1e-30) in bf16. Each of the 256 consumer threads owns
// items of 4 columns of one row (pieces share m and l along a row) and
// keeps kBatch of them in flight a piece, so the folds of a piece overlap
// their loads instead of waiting on one L2 round trip each. Scratch is
// read with ld.global.cg: other CTAs wrote it.
template <int D>
__device__ __forceinline__ void merge_rows(const Args& a, int seg, int start, int count,
                                           int row0, int nrows) {
  constexpr int kGroups = D / 4;                      // float4 items a row
  constexpr int kBatch = 8;                           // items in flight a thread
  constexpr int kPass = 256 * kBatch;
  const int t = threadIdx.x - 128;
  for (int base = 0; base < kRows * kGroups; base += kPass) {
    float4 acc[kBatch];
    float m[kBatch], l[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[k] = attn::kNegInf;
      l[k] = 0.f;
    }
    for (int p = start; p < start + count; ++p) {
      float4 op[kBatch];
      float mp[kBatch], lp[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int item = base + t + k * 256, r = item / kGroups;
        if (r >= nrows) continue;
        const size_t pr = (size_t)p * a.rows + row0 + r;
        op[k] = __ldcg(reinterpret_cast<const float4*>(a.o_p + pr * D) + item % kGroups);
        mp[k] = __ldcg(a.m_p + pr);
        lp[k] = __ldcg(a.l_p + pr);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if ((base + t + k * 256) / kGroups >= nrows) continue;
        // attn::merge_piece on each of the 4 columns, which share m and l
        const float m_new = fmaxf(m[k], mp[k]);
        const float a_old = (isinf(m[k]) && m[k] < 0.f) ? 0.f : expf(m[k] - m_new);
        const float a_new = (isinf(mp[k]) && mp[k] < 0.f) ? 0.f : expf(mp[k] - m_new);
        l[k] = a_old * l[k] + a_new * lp[k];
        acc[k].x = a_old * acc[k].x + a_new * op[k].x;
        acc[k].y = a_old * acc[k].y + a_new * op[k].y;
        acc[k].z = a_old * acc[k].z + a_new * op[k].z;
        acc[k].w = a_old * acc[k].w + a_new * op[k].w;
        m[k] = m_new;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + t + k * 256, r = item / kGroups;
      if (r >= nrows) continue;
      const float den = fmaxf(l[k], 1e-30f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[k].x / den, acc[k].y / den);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[k].z / den, acc[k].w / den);
      *reinterpret_cast<uint2*>(a.out + ((size_t)seg * a.rows + row0 + r) * D +
                                (item % kGroups) * 4) =
          make_uint2(attn_tc::bf16x2_bits(lo), attn_tc::bf16x2_bits(hi));
    }
  }
}

// A piece's last column: write it to the output (one piece) or to scratch,
// and merge the row block's pieces if this CTA completes the segment.
template <int D>
__device__ __forceinline__ void flush_piece(const Args& a, const Column& c, int row0, int nrows,
                                            int rb, int rA, const float (&o)[D / 2],
                                            const float (&m)[2], const float (&l)[2],
                                            int* merge_here) {
  const int lane = threadIdx.x % 32;
  float lr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lr[i] += __shfl_xor_sync(0xffffffffu, lr[i], 2);
  }
  const int count = a.piece_count[c.seg];
  const size_t seg_row0 = (size_t)c.seg * a.rows + row0;
  if (count == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rA + 8 * i;
      if (r >= nrows) continue;
      const float den = fmaxf(lr[i], 1e-30f);
      __nv_bfloat16* dst = a.out + (seg_row0 + r) * D + (lane % 4) * 2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * 8) =
            __floats2bfloat162_rn(o[nb * 4 + 2 * i] / den, o[nb * 4 + 2 * i + 1] / den);
    }
    return;
  }
  const size_t base = (size_t)c.piece * a.rows + row0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rA + 8 * i;
    if (r >= nrows) continue;
    float* dst = a.o_p + (base + r) * D + (lane % 4) * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(dst + nb * 8) =
          make_float2(o[nb * 4 + 2 * i], o[nb * 4 + 2 * i + 1]);
    if (lane % 4 == 0) {   // m in natural-log units, as the plain version's
      a.m_p[base + r] = m[i] == attn_tc::kNegInf ? attn::kNegInf : m[i] * 0.6931471805599453f;
      a.l_p[base + r] = lr[i];
    }
  }
  __threadfence();   // this thread's piece writes, device-wide
  asm volatile("bar.sync %0, 256;\n" ::"r"(kFlushBar) : "memory");
  if (threadIdx.x == 128) {
    int* arrival = a.arrivals + (size_t)c.seg * a.num_rb + rb;
    const bool last = atomicAdd(arrival, 1) + 1 == count;
    if (last) *arrival = 0;   // left zeroed for the next launch
    *merge_here = last;
  }
  asm volatile("bar.sync %0, 256;\n" ::"r"(kFlushBar) : "memory");
  if (!*merge_here) return;
  __threadfence();
  merge_rows<D>(a, c.seg, a.piece_start[c.seg], count, row0, nrows);
}

template <int D, int KV>
__device__ __forceinline__ void consume_stream(const Args& a, int worker, int row0, int nrows,
                                               int pmax, int rb, uint32_t q_s, uint32_t k_s,
                                               uint32_t v_s, uint32_t bar0, int* merge_here) {
  constexpr uint32_t kTile = (D / 64) * kPanelBytes;
  constexpr int kO = D / 2;
  const int c = threadIdx.x / 128 - 1;      // consumer 0 or 1
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rA = c * kWgRows + warp * 16 + lane / 4;
  const int C = a.chunk_cap;
  const int pos[2] = {(row0 + rA) % C, (row0 + rA + 8) % C};
  const int wg_n = min(kWgRows, nrows - c * kWgRows);
  int wg_pmin = 0, unused;
  if (wg_n > 0) attn_tc::pos_range(row0 + c * kWgRows, wg_n, C, wg_pmin, unused);
  const uint32_t q_wg = q_s + c * kWgRows * 128;
  float o[kO], m[2] = {attn_tc::kNegInf, attn_tc::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kO; ++k) o[k] = 0.f;
  int it = 0, qn = 0, q_seg = -1;
  for (int t = 0; t < a.tiles_per_worker; ++t) {
    const int i = worker * a.tiles_per_worker + t;
    const Column col = column(a, i, pmax);
    if (!col.valid) continue;   // padding column
    if (col.first) {
#pragma unroll
      for (int k = 0; k < kO; ++k) o[k] = 0.f;
      m[0] = m[1] = attn_tc::kNegInf;   // units of log2
      l[0] = l[1] = 0.f;
    }
    if (col.nsub > 0) {
      if (col.seg != q_seg) {
        if (qn > 0) {   // this warp is done with the old segment's Q
          __syncwarp();
          if (lane == 0) attn_tc::mbar_arrive(bar0 + 8 * BAR_QFREE);
        }
        attn_tc::mbar_wait(bar0 + 8 * BAR_Q, qn & 1);
        ++qn;
        q_seg = col.seg;
      }
      const int qs = a.seg_qstart[col.seg], kend = col.kv_start + col.vlen;
      const int lo[2] = {0, 0};
      const int hi[2] = {min(kend, qs + pos[0] + 1), min(kend, qs + pos[1] + 1)};
      const int wg_hi = wg_n > 0 ? min(kend, qs + wg_pmin + 1) : INT_MAX;
      float ks = 1.f, vs = 1.f;
      if constexpr (KV == KV_INT8) {
        ks = a.k_scales[a.route[i]];
        vs = a.v_scales[a.route[i]];
      }
      for (int sub = 0; sub < col.nsub; ++sub, ++it) {
        const int s = it % kStages;
        attn_tc::tile_update<D, KV == KV_INT8>(
            o, m, l, q_wg, k_s + s * kTile, v_s + s * kTile, bar0 + 8 * (BAR_K + s),
            bar0 + 8 * (BAR_V + s), (it / kStages) & 1, col.kv_start + sub * kKeys,
            min(kKeys, a.page - sub * kKeys), lo, hi, 0, wg_hi, col.kv_start,
            col.kv_start + col.jmax, a.scale_log2, ks, vs);
        __syncwarp();
        if (lane == 0) attn_tc::mbar_arrive(bar0 + 8 * (BAR_EMPTY + s));
      }
    }
    if (col.last) flush_piece<D>(a, col, row0, nrows, rb, rA, o, m, l, merge_here);
  }
}

// ------------------------------------------------------------------ kernel
template <int D, int KV>
__global__ void __launch_bounds__(attn_tc::kThreads, 1)
    lean_prefill_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const Args a) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  __shared__ int merge_here;
  constexpr uint32_t kTile = (D / 64) * kPanelBytes;
  const uint32_t q_s = (attn_tc::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kTile;
  const uint32_t v_s = k_s + kStages * kTile;
  const uint32_t st_s = v_s + kStages * kTile;   // 1-byte staging
  const uint32_t bar0 = attn_tc::smem_u32(bars);
  const int worker = blockIdx.x, rb = blockIdx.y, row0 = rb * kRows;
  const int nrows = min(kRows, a.rows - row0);
  int pmin, pmax;
  attn_tc::pos_range(row0, nrows, a.chunk_cap, pmin, pmax);
  if (threadIdx.x == 0) {
    attn_tc::mbar_init(bar0 + 8 * BAR_Q, 1);
    attn_tc::mbar_init(bar0 + 8 * BAR_QFREE, 8);   // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      attn_tc::mbar_init(bar0 + 8 * (BAR_K + s), 1);
      attn_tc::mbar_init(bar0 + 8 * (BAR_V + s), 1);
      attn_tc::mbar_init(bar0 + 8 * (BAR_EMPTY + s), 8);
      attn_tc::mbar_init(bar0 + 8 * (BAR_STAGE + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if constexpr (KV != KV_BF16)
      produce_staged<D, KV>(a, worker, row0, pmax, q_s, k_s, v_s, st_s, bar0, &qmap, &kmap,
                            &vmap);
    else if (threadIdx.x == 0)
      produce_bf16<D>(a, worker, row0, pmax, q_s, k_s, v_s, bar0, &qmap, &kmap, &vmap);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume_stream<D, KV>(a, worker, row0, nrows, pmax, rb, q_s, k_s, v_s, bar0, &merge_here);
  }
}

// Dynamic shared memory: Q, the K and V rings, and for 1-byte pages the
// staging ring of their K and V tiles, plus alignment.
size_t smem_bytes(int d, bool staged) {
  return attn_tc::smem_bytes(d) + (staged ? (size_t)kStages * 2 * kKeys * d : 0);
}

template <int D, int KV>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const Args& a, int num_workers, cudaStream_t stream) {
  auto kernel = lean_prefill_tc_kernel<D, KV>;
  const size_t smem = smem_bytes(D, KV != KV_BF16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_workers, a.num_rb), attn_tc::kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 1 = bf16 q and K/V rows, 2 = bf16 q with int8 K/V rows and their
// float32 row scales, 3 = bf16 q with e4m3 K/V rows. d 64 or 128, page a
// multiple of 8; q and the rows
// 16-byte aligned. S segments of `rows` query rows, R pool rows of `page`
// keys; arrivals (S, ceil(rows / 128)) zero (and left zero).
int lean_prefill_fused_tc_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                                 const float* k_scales, const float* v_scales, const int* desc,
                                 int n_cols, int tiles_per_worker, int num_workers,
                                 const int* seg_ctx, const int* seg_qstart, const int* route,
                                 const int* piece_start, const int* piece_count, int* arrivals,
                                 float* o_p, float* m_p, float* l_p, void* out, int S, int R,
                                 int rows, int chunk_cap, int d, int page, float scale,
                                 void* stream) {
  if (num_workers <= 0 || S <= 0 || R <= 0 || rows <= 0 || chunk_cap <= 0 || page <= 0 ||
      page % 8 || (d != 64 && d != 128) || dtype < 1 || dtype > 3)
    return (int)cudaErrorInvalidValue;
  const int kv = dtype == 2 ? KV_INT8 : dtype == 3 ? KV_F8 : KV_BF16;
  if (kv == KV_INT8 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool staged = kv != KV_BF16;
  const int box = std::min(page, kKeys);
  CUtensorMap qm, km, vm;
  int err = attn_tc::encode_rows(&qm, q, d, rows, S, kRows);
  if (!err && !staged) err = attn_tc::encode_rows(&km, k_rows, d, page, R, box);
  if (!err && !staged) err = attn_tc::encode_rows(&vm, v_rows, d, page, R, box);
  if (!err && staged) err = attn_tc::encode_bytes(&km, k_rows, d, page, R, box);
  if (!err && staged) err = attn_tc::encode_bytes(&vm, v_rows, d, page, R, box);
  if (err) return err;
  const Args a = {desc,     seg_ctx, seg_qstart, route, k_scales, v_scales, piece_start,
                  piece_count, arrivals, o_p, m_p, l_p, static_cast<__nv_bfloat16*>(out),
                  n_cols,   tiles_per_worker, rows, chunk_cap, page, (rows + kRows - 1) / kRows,
                  scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)(kv == KV_INT8 ? launch<64, KV_INT8>(qm, km, vm, a, num_workers, st)
                 : kv == KV_F8 ? launch<64, KV_F8>(qm, km, vm, a, num_workers, st)
                               : launch<64, KV_BF16>(qm, km, vm, a, num_workers, st));
  return (int)(kv == KV_INT8 ? launch<128, KV_INT8>(qm, km, vm, a, num_workers, st)
               : kv == KV_F8 ? launch<128, KV_F8>(qm, km, vm, a, num_workers, st)
                             : launch<128, KV_BF16>(qm, km, vm, a, num_workers, st));
}

}  // extern "C"
