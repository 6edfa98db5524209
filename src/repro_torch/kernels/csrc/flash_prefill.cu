// FA-2 chunked prefill through the page table for Hopper: K8, the
// fixed-grid baseline of the chunked-prefill path.
//
// Replaces the Pallas TPU kernel of the reference:
//   K8  repro/kernels/flash_prefill.py:162  _prefill_paged_kernel
//       (driven by flash_prefill_paged :230)
//
// Each pack row n is one prompt chunk of C query positions starting at the
// runtime offset q_off[n]; its K/V (everything prefilled so far plus the
// chunk itself) lie in the page pool behind table row tbl[n]. Query row at
// position p sees keys 0..p; the causal test doubles as the length guard,
// since stale data in unwritten pages always sits past every valid query.
// Pages past the block's last query position are not visited. The output
// is normalised with l = max(l, 1e-30) and written in q's dtype.
//
// Design. The g query heads of a KV head are folded into one CTA's rows:
// rows = g * C, flattened (g, C) chunk-minor -- the same row layout as K4,
// so K8 shares K4's row-block update (attn::rows_tile_update) and a page is
// read once per row block instead of once per query head. The grid is
// (pack row x KV head, row block of 64 rows); each CTA walks the table row
// page by page, in order, up to the causal limit.
//
// What bounds it on this card: like K4, the flops of a 256-token chunk
// over a 2048-token prefix outweigh its K/V bytes (above the ridge point);
// this version computes on the CUDA cores in float32.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t.

#include "attn_tile.cuh"

namespace {

using attn::kBlockRows;
using attn::kRowThreads;
using attn::RowSmem;

struct Args {
  const void* q;        // (N * n_kv, rows, d), rows = g * C
  const void* k_rows;   // (num_pages * n_kv, page, d) pool rows
  const void* v_rows;
  const int* tbl;       // (N, W) page table rows
  const int* q_off;     // (N,) absolute position of each chunk's q[0]
  void* out;            // (N * n_kv, rows, d), q's dtype
  int n_kv, W, rows, chunk_cap, d, page;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) flash_prefill_paged_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.page);
  __shared__ int jmax_s;
  const int d = a.d, page = a.page, C = a.chunk_cap, ld = d + 1;
  const int nh = blockIdx.x, n = nh / a.n_kv, h = nh % a.n_kv;
  const int row0 = blockIdx.y * kBlockRows;
  const int nrows = min(kBlockRows, a.rows - row0);
  const size_t row_elems = (size_t)page * d;
  const T* k_rows = static_cast<const T*>(a.k_rows);
  const T* v_rows = static_cast<const T*>(a.v_rows);

  attn::reset_rows(s, d);
  attn::load_rows<T>(static_cast<const T*>(a.q) + ((size_t)nh * a.rows + row0) * d, nrows, s, d);
  const int q_off = a.q_off[n];
  // the block's rows hold the chunk positions (row0 .. row0 + nrows - 1) % C
  const int first_pos = row0 % C;
  const int last_pos = first_pos + nrows - 1 >= C ? C - 1 : first_pos + nrows - 1;
  const int max_qpos = q_off + last_pos;
  for (int jb = 0; jb < a.W && jb * page <= max_qpos; ++jb) {
    const int k_start = jb * page;
    if (threadIdx.x == 0) jmax_s = 0;
    __syncthreads();
    if (threadIdx.x < kBlockRows) {
      const int r = threadIdx.x;
      int lim = 0;
      if (r < nrows) lim = max(min(page, q_off + (row0 + r) % C - k_start + 1), 0);
      s.lim[r] = lim;
      atomicMax(&jmax_s, lim);
    }
    __syncthreads();
    const int jmax = jmax_s;
    if (jmax > 0) {
      const size_t row = (size_t)a.tbl[(size_t)n * a.W + jb] * a.n_kv + h;
      attn::rows_tile_update<T>(k_rows + row * row_elems, v_rows + row * row_elems, jmax, s, d,
                                page, a.scale);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)nh * a.rows + row0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kRowThreads) {
    const int r = e / d, c = e - r * d;
    attn::store(out + (size_t)r * d + c, s.acc[r * ld + c] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int num_rows, cudaStream_t stream) {
  auto kernel = flash_prefill_paged_kernel<T>;
  const size_t smem = attn::row_smem_bytes(a.d, a.page);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_rows, (a.rows + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kRowThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and the output share it).
int flash_prefill_paged_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                               const int* tbl, const int* q_off, void* out, int N, int n_kv,
                               int W, int rows, int chunk_cap, int d, int page, float scale,
                               void* stream) {
  if (N <= 0 || n_kv <= 0 || W <= 0 || rows <= 0 || chunk_cap <= 0 || d <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k_rows, v_rows, tbl, q_off, out, n_kv, W, rows, chunk_cap, d, page, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_typed<float>(a, N * n_kv, st);
    case 1: return (int)launch_typed<__nv_bfloat16>(a, N * n_kv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
