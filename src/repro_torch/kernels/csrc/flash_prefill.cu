// FA-2 prefill for Hopper: K7, the whole-prompt prefill of the dense-cache
// engine, and K8, the fixed-grid baseline of the chunked-prefill path.
//
// Replaces the Pallas TPU kernels of the reference:
//   K7  repro/kernels/flash_prefill.py:24   _prefill_kernel
//       (driven by flash_prefill :96, pallas_call :138)
//   K8  repro/kernels/flash_prefill.py:162  _prefill_paged_kernel
//       (driven by flash_prefill_paged :230)
//
// K7. q (B, Hq, Lq, d) against dense k/v (B, Hkv, Lk, d); query i sits at
// absolute position q_offset + i and sees the keys kpos < Lk with, when
// causal, kpos <= qpos and, with a window W, kpos > qpos - W. The TPU
// kernel walks a (q block, kv block) grid and skips fully masked blocks with
// pl.when; here each CTA's loop bounds are that skip: a CTA walks the key
// tiles from the first one the window lets in to the last one the causal
// diagonal reaches, so causal work is about half of Lq x Lk and windowed
// work O(W). Lk is a runtime bound on every row's range, so the ragged last
// tile is masked and never read past Lk.
//
// K8. Each pack row n is one prompt chunk of C query positions starting at
// the runtime offset q_off[n]; its K/V (everything prefilled so far plus the
// chunk itself) lie in the page pool behind table row tbl[n]. Query row at
// position p sees keys 0..p; the causal test doubles as the length guard,
// since stale data in unwritten pages always sits past every valid query.
// Pages past the block's last query position are not visited.
//
// Both normalise with l = max(l, 1e-30) and write in q's dtype.
//
// Design. The g query heads of a KV head are folded into one CTA's rows:
// rows = g * L, flattened (g, L) position-minor -- q's own memory layout, and
// K4's row layout -- so both share K4's row-block update
// (attn::rows_tile_update) and a K/V tile is read once per row block of 64
// rows instead of once per query head. The grid is (batch row x KV head,
// row block of 64 rows); each CTA walks its key tiles in order.
//
// What bounds them on this card: operations. At the main path's shapes (K7:
// Hq 32, Hkv 8, d 128, a 3000-token causal prompt, 73.7 GFLOP against 61 MB
// of bf16 q, k, v and o; K8: a 256-token chunk over a 2048-token prefix) the
// flops outweigh the bytes by far more than the card's ridge point. This
// version computes on the CUDA cores in float32 (register-tiled 4 x 8 per
// thread, tiles in shared memory); the tensor cores (wgmma) and TMA are the
// later step.
//
// Plain C interface (loaded with ctypes); each entry returns the launch's
// cudaError_t.

#include "attn_tile.cuh"

namespace {

using attn::kBlockRows;
using attn::kRowThreads;
using attn::RowSmem;

// ------------------------------------------------------------------- K7
struct DenseArgs {
  const void* q;        // (B * n_kv, rows, d), rows = g * Lq
  const void* k;        // (B * n_kv, Lk, d)
  const void* v;
  void* out;            // (B * n_kv, rows, d), q's dtype
  int rows, Lq, Lk, d, tile, causal, window, q_offset;
  float scale;
};

template <typename T, bool kWindow>
__global__ void __launch_bounds__(kRowThreads) flash_prefill_kernel(DenseArgs a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.tile);
  __shared__ int klo_s, khi_s, jmax_s;
  const int d = a.d, tile = a.tile, ld = d + 1;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBlockRows;
  const int nrows = min(kBlockRows, a.rows - row0);
  const size_t head = (size_t)bh * a.Lk * d;
  const T* k = static_cast<const T*>(a.k) + head;
  const T* v = static_cast<const T*>(a.v) + head;

  attn::reset_rows(s, d);
  attn::load_rows<T>(static_cast<const T*>(a.q) + ((size_t)bh * a.rows + row0) * d, nrows, s, d);
  if (threadIdx.x == 0) {
    klo_s = a.Lk;
    khi_s = 0;
  }
  __syncthreads();
  // row r of the block (thread r) sees the keys [row_lo, row_hi)
  int row_lo = 0, row_hi = 0;
  if (threadIdx.x < nrows) {
    const int qpos = a.q_offset + (row0 + (int)threadIdx.x) % a.Lq;
    row_hi = a.causal ? max(min(a.Lk, qpos + 1), 0) : a.Lk;
    row_lo = kWindow ? max(qpos - a.window + 1, 0) : 0;
    if (row_lo < row_hi) {
      atomicMin(&klo_s, row_lo);
      atomicMax(&khi_s, row_hi);
    }
  }
  __syncthreads();
  const int khi = khi_s;
  for (int k_start = (klo_s / tile) * tile; k_start < khi; k_start += tile) {
    if (threadIdx.x == 0) jmax_s = 0;
    __syncthreads();
    if (threadIdx.x < kBlockRows) {
      const int r = threadIdx.x;
      int lo = min(max(row_lo - k_start, 0), tile);
      int hi = min(max(row_hi - k_start, 0), tile);
      if (lo >= hi) lo = hi = 0;  // the row sees no key of this tile
      s.lim[r] = hi;
      s.lo[r] = lo;
      if (hi > 0) atomicMax(&jmax_s, hi);
    }
    __syncthreads();
    const int jmax = jmax_s;
    if (jmax > 0)
      attn::rows_tile_update<T, kWindow>(k + (size_t)k_start * d, v + (size_t)k_start * d, jmax,
                                         s, d, tile, a.scale);
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.rows + row0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kRowThreads) {
    const int r = e / d, c = e - r * d;
    attn::store(out + (size_t)r * d + c, s.acc[r * ld + c] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T, bool kWindow>
cudaError_t launch_dense(const DenseArgs& a, int num_bh, cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, kWindow>;
  const size_t smem = attn::row_smem_bytes(a.d, a.tile);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_bh, (a.rows + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kRowThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dense_typed(const DenseArgs& a, int num_bh, cudaStream_t stream) {
  return a.window > 0 ? launch_dense<T, true>(a, num_bh, stream)
                      : launch_dense<T, false>(a, num_bh, stream);
}

// ------------------------------------------------------------------- K8
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

// K7. dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// window <= 0: no window.
int flash_prefill_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                         int num_bh, int rows, int Lq, int Lk, int d, int tile, int causal,
                         int window, int q_offset, float scale, void* stream) {
  if (num_bh <= 0 || rows <= 0 || Lq <= 0 || Lk <= 0 || d <= 0 || tile <= 0 || rows % Lq)
    return (int)cudaErrorInvalidValue;
  DenseArgs a = {q, k, v, out, rows, Lq, Lk, d, tile, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dense_typed<float>(a, num_bh, st);
    case 1: return (int)launch_dense_typed<__nv_bfloat16>(a, num_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8. dtype: 0 = float32, 1 = bfloat16 (q, the pools and the output share it).
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
