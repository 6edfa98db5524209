// Stream-K chunked-prefill partials for Hopper: K4.
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
// TFLOP/s); tensor-core wgmma on staged bf16 tiles is later work.
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
// A block may span two heads when C is not a multiple of 64.
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
  const int* desc;        // (7, n_cols)
  const int* seg_ctx;     // (S,) visible KV length of each segment
  const int* seg_qstart;  // (S,) absolute position of each segment's q[0]
  const int* route;       // (n_cols,) pool row per column
  float* o_p;             // (P+1, rows, d) piece partials
  float* m_p;             // (P+1, rows)
  float* l_p;
  int n_cols, tiles_per_worker, rows, chunk_cap, d, tile;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) lean_prefill_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.tile);
  __shared__ int jmax_s;
  const int d = a.d, tile = a.tile, N = a.n_cols, ld = d + 1;
  const T* q = static_cast<const T*>(a.q);
  const T* k_rows = static_cast<const T*>(a.k_rows);
  const T* v_rows = static_cast<const T*>(a.v_rows);
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
      attn::load_rows<T>(q + ((size_t)seg * a.rows + row0) * d, nrows, s, d);
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
      attn::rows_tile_update<T>(k_rows + row * row_elems, v_rows + row * row_elems, jmax, s,
                                d, tile, a.scale);
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
    }
    __syncthreads();  // shared state is reused by the next column
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int num_workers, cudaStream_t stream) {
  auto kernel = lean_prefill_kernel<T>;
  const size_t smem = attn::row_smem_bytes(a.d, a.tile);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_workers, (a.rows + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kRowThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_rows and v_rows share it).
int lean_prefill_partials_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                                 const int* desc, int n_cols, int tiles_per_worker,
                                 int num_workers, const int* seg_ctx, const int* seg_qstart,
                                 const int* route, float* o_p, float* m_p, float* l_p, int rows,
                                 int chunk_cap, int d, int tile, float scale, void* stream) {
  if (num_workers <= 0 || rows <= 0 || chunk_cap <= 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {q,   k_rows, v_rows, desc, seg_ctx, seg_qstart, route, o_p, m_p,  l_p,
            n_cols, tiles_per_worker, rows, chunk_cap, d, tile, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_typed<float>(a, num_workers, st);
    case 1: return (int)launch_typed<__nv_bfloat16>(a, num_workers, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
