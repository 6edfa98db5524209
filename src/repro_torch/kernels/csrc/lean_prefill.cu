// Stream-K chunked prefill for Hopper on the CUDA cores: K4's partials
// (the fused=False paths), and the fused form -- partials and their merge
// in one launch -- where the path rule does not take the tensor-core kernel
// (lean_prefill_tc.cu): float32, head dims other than 64 and 128, pages
// that are not a multiple of 8 rows.
//
// Replaces the Pallas TPU kernel of the reference:
//   K4  repro/kernels/lean_prefill.py:51  _lean_prefill_kernel
//       (driven by lean_prefill_chunk_partials :140)
//
// A pack of N prompt chunks is a decode workload with taller segments: the
// segment (chunk, kv_head) has rows = g * C query rows, flattened (g, C)
// chunk-minor, so row R sits at absolute position qstart[seg] + R % C and
// sees the keys kv_start + j <= that position (and < ctx[seg], the runtime
// visible length). The stream-K schedule, its descriptors and the phase-2
// merge (segment_merge) are the decode ones.
//
// What bounds it on this card: at the main path's shapes (chunk 256 at
// offset 2048, 32 query heads, d 128) a chunk does about 9 GFLOP against
// 9.4 MB of K/V -- above the bf16 ridge point, so the first kernel of the
// port whose floor is operations, not bytes. Its f32 partials ((P+1) x rows
// x d, about 0.5 MB a piece) are written once and read once by the merge.
// This version computes on the CUDA cores in float32 (floor about 67
// TFLOP/s); bf16 at the main path's shapes runs lean_prefill_tc.cu.
//
// Design. K1's layout (all gq rows of a segment in one CTA) does not fit:
// 1024 rows of f32 accumulators are 512 KB, more than a CTA's 227 KB. So
// the rows are split: the grid is (worker, row block of 64 rows). Each CTA
// walks its worker's descriptor columns for its own rows -- rows are
// independent in online softmax, so the schedule and the merge stay as
// they are -- and flushes its rows of each piece. Per tile it computes each
// row's count of visible keys (a prefix: j < min(vlen, qpos - kv_start +
// 1)), reads only the K/V rows some row of the block sees, and skips a tile
// no row sees (the update would leave acc, m and l unchanged) while still
// honouring the column's first (reset) and last (flush). A row that sees no
// key of a piece flushes m = -1e30, l = 0: the merge gives it zero weight.
// A block may span two heads when C is not a multiple of 64. A page whose
// float32 tile would not fit beside the block's state in shared memory (d
// 128 above 208 keys) is walked in sub-tiles (attn::rows_page_update,
// attn::row_sub_tile), in key order; a page that fits is one update.
//
// Fused (FUSED = true): the pieces go to float32 scratch and each CTA that
// flushes one bumps the arrival counter of (segment, row block); the CTA
// whose arrival completes it folds the row block's pieces in piece order
// (attn::merge_piece, K2's fix-up) and writes o / max(l, 1e-30) in q's
// dtype. No CTA waits for another.
//
// int8 pools (dtype code 2, the reference's quantized body): bf16 queries,
// int8 K/V rows and a float32 scale per pool row for K and for V. The tile
// loader widens 16 int8 values a load and multiplies them by the routed
// row's scale as it writes the float32 tile; the update is the float one.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t.

#include "attn_tile.cuh"

namespace {

using attn::kBlockRows;
using attn::kRowThreads;
using attn::RowSmem;

enum { DESC_SEG = 0, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID };
enum { OP_PARTIAL = 1 };

struct Args {
  const void* q;          // (S, rows, d)
  const void* k_rows;     // (R, tile, d) pool rows
  const void* v_rows;
  const float* k_scales;  // (R,) int8 rows only
  const float* v_scales;
  const int* desc;        // (7, n_cols)
  const int* seg_ctx;     // (S,) visible KV length of each segment
  const int* seg_qstart;  // (S,) absolute position of each segment's q[0]
  const int* route;       // (n_cols,) pool row per column
  float* o_p;             // (P+1, rows, d) piece partials (the fused kernel's scratch)
  float* m_p;             // (P+1, rows)
  float* l_p;
  // fused only
  const int* piece_start; // (S,)
  const int* piece_count; // (S,)
  int* arrivals;          // (S, row blocks) zero at launch; re-zeroed by the last arriver
  void* out;              // (S, rows, d), q's dtype
  int n_cols, tiles_per_worker, rows, chunk_cap, d, tile, sub;
  float scale;
};

// The fused kernel's fix-up: fold the pieces [start, start + count) of
// `seg` for this block's rows in piece order (K2's, lean_decode.cu), and
// write o / max(l, 1e-30) in q's dtype. Scratch is read with ld.global.cg:
// other CTAs wrote it.
template <typename Q>
__device__ __forceinline__ void merge_rows(const Args& a, int seg, int row0, int nrows) {
  const int start = a.piece_start[seg], count = a.piece_count[seg], d = a.d;
  Q* out = static_cast<Q*>(a.out) + ((size_t)seg * a.rows + row0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kRowThreads) {
    const int r = e / d;
    float acc = 0.f, m = attn::kNegInf, l = 0.f;
    for (int p = start; p < start + count; ++p) {
      const size_t pr = (size_t)p * a.rows + row0 + r;
      attn::merge_piece(__ldcg(a.o_p + pr * d + (e - r * d)), __ldcg(a.m_p + pr),
                        __ldcg(a.l_p + pr), acc, m, l);
    }
    attn::store(out + e, acc / fmaxf(l, 1e-30f));
  }
}

// Q: the queries' type; KV: the K/V rows' (Q, or int8_t with scales).
// FUSED: the partials go to scratch and the last CTA to arrive at (segment,
// row block) merges them into the output.
template <typename Q, typename KV, bool FUSED>
__global__ void __launch_bounds__(kRowThreads) lean_prefill_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.sub);
  __shared__ int jmax_s, merge_here;
  const int d = a.d, tile = a.tile, N = a.n_cols, ld = d + 1;
  const Q* q = static_cast<const Q*>(a.q);
  const KV* k_rows = static_cast<const KV*>(a.k_rows);
  const KV* v_rows = static_cast<const KV*>(a.v_rows);
  const size_t row_elems = (size_t)tile * d;

  const int g = blockIdx.x;
  const int row0 = blockIdx.y * kBlockRows;
  const int nrows = min(kBlockRows, a.rows - row0);
  int cur_seg = -1;
  for (int t = 0; t < a.tiles_per_worker; ++t) {
    const int i = g * a.tiles_per_worker + t;
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) continue;  // padding column
    const int seg = a.desc[DESC_SEG * N + i];
    const int kv_start = a.desc[DESC_TILE * N + i] * tile;
    const int piece = a.desc[DESC_PIECE * N + i];
    const bool first = a.desc[DESC_FIRST * N + i] != 0;
    const bool last = a.desc[DESC_LAST * N + i] != 0;

    if (first) attn::reset_rows(s, d);
    if (seg != cur_seg) {
      attn::load_rows<Q>(q + ((size_t)seg * a.rows + row0) * d, nrows, s, d);
      cur_seg = seg;
    }
    if (threadIdx.x == 0) jmax_s = 0;
    __syncthreads();
    const int vlen = min(max(a.seg_ctx[seg] - kv_start, 0), tile);
    if (threadIdx.x < kBlockRows) {
      const int r = threadIdx.x;
      int lim = 0;
      if (r < nrows) {
        const int qpos = a.seg_qstart[seg] + (row0 + r) % a.chunk_cap;
        lim = max(min(vlen, qpos - kv_start + 1), 0);
      }
      s.lim[r] = lim;
      atomicMax(&jmax_s, lim);
    }
    __syncthreads();
    const int jmax = jmax_s;
    if (jmax > 0) {
      const size_t row = (size_t)a.route[i];
      float ks = 1.f, vs = 1.f;
      if constexpr (attn::is_int8<KV>) {
        ks = a.k_scales[row];
        vs = a.v_scales[row];
      }
      attn::rows_page_update<KV>(k_rows + row * row_elems, v_rows + row * row_elems, jmax, s,
                                 d, a.sub, a.scale, ks, vs);
    }
    if (last) {  // StorePartials for this block's rows of the piece
      const size_t base = (size_t)piece * a.rows + row0;
      for (int e = threadIdx.x; e < nrows * d; e += kRowThreads) {
        const int r = e / d, c = e - r * d;
        a.o_p[(base + r) * d + c] = s.acc[r * ld + c];
      }
      for (int r = threadIdx.x; r < nrows; r += kRowThreads) {
        a.m_p[base + r] = s.m[r];
        a.l_p[base + r] = s.l[r];
      }
      if (FUSED) {
        __threadfence();  // this thread's piece writes, device-wide
        __syncthreads();
        if (threadIdx.x == 0) {
          int* arrival = a.arrivals + (size_t)seg * gridDim.y + blockIdx.y;
          merge_here = atomicAdd(arrival, 1) + 1 == a.piece_count[seg];
          if (merge_here) *arrival = 0;   // left zeroed for the next launch
        }
        __syncthreads();
        if (merge_here) {
          __threadfence();
          merge_rows<Q>(a, seg, row0, nrows);
        }
      }
    }
    __syncthreads();  // shared state is reused by the next column
  }
}

template <typename Q, typename KV, bool FUSED>
cudaError_t launch_typed(const Args& a, int num_workers, cudaStream_t stream) {
  auto kernel = lean_prefill_kernel<Q, KV, FUSED>;
  const size_t smem = attn::row_smem_bytes(a.d, a.sub);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_workers, (a.rows + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kRowThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
int launch(int dtype, const Args& a, int num_workers, cudaStream_t st) {
  switch (dtype) {
    case 0: return (int)launch_typed<float, float, FUSED>(a, num_workers, st);
    case 1: return (int)launch_typed<__nv_bfloat16, __nv_bfloat16, FUSED>(a, num_workers, st);
    case 2:
      if (a.k_scales == nullptr || a.v_scales == nullptr || a.d % attn::kVec)
        return (int)cudaErrorInvalidValue;
      return (int)launch_typed<__nv_bfloat16, int8_t, FUSED>(a, num_workers, st);
    case 3:
      if (a.d % attn::kVec) return (int)cudaErrorInvalidValue;
      return (int)launch_typed<__nv_bfloat16, attn::e4m3, FUSED>(a, num_workers, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_rows and v_rows share it), 2 =
// bf16 q with int8 k_rows and v_rows and their float32 row scales (NULL
// otherwise), 3 = bf16 q with e4m3 k_rows and v_rows.
int lean_prefill_partials_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                                 const float* k_scales, const float* v_scales,
                                 const int* desc, int n_cols, int tiles_per_worker,
                                 int num_workers, const int* seg_ctx, const int* seg_qstart,
                                 const int* route, float* o_p, float* m_p, float* l_p, int rows,
                                 int chunk_cap, int d, int tile, float scale, void* stream) {
  if (num_workers <= 0 || rows <= 0 || chunk_cap <= 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  const int sub = attn::row_sub_tile(d, tile);
  if (sub == 0) return (int)cudaErrorInvalidValue;
  Args a = {q,       k_rows,  v_rows,  k_scales, v_scales, desc, seg_ctx, seg_qstart, route,
            o_p,     m_p,     l_p,     nullptr,  nullptr,  nullptr, nullptr, n_cols,
            tiles_per_worker, rows, chunk_cap, d, tile, sub, scale};
  return launch<false>(dtype, a, num_workers, static_cast<cudaStream_t>(stream));
}

// The partials and their merge in one launch (the CUDA-core path of the
// fused chunk prefill): operands as above, o_p/m_p/l_p scratch, piece
// ranges per segment, arrivals (S, ceil(rows / 64)) zero (and left zero),
// out (S, rows, d) in q's dtype.
int lean_prefill_fused_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                              const float* k_scales, const float* v_scales, const int* desc,
                              int n_cols, int tiles_per_worker, int num_workers,
                              const int* seg_ctx, const int* seg_qstart, const int* route,
                              const int* piece_start, const int* piece_count, int* arrivals,
                              float* o_p, float* m_p, float* l_p, void* out, int rows,
                              int chunk_cap, int d, int tile, float scale, void* stream) {
  if (num_workers <= 0 || rows <= 0 || chunk_cap <= 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  const int sub = attn::row_sub_tile(d, tile);
  if (sub == 0) return (int)cudaErrorInvalidValue;
  Args a = {q,       k_rows,      v_rows,      k_scales, v_scales, desc, seg_ctx, seg_qstart,
            route,   o_p,         m_p,         l_p,      piece_start, piece_count, arrivals,
            out,     n_cols,      tiles_per_worker, rows, chunk_cap, d, tile, sub, scale};
  return launch<true>(dtype, a, num_workers, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
