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
// K8 on the f8 pools (dtype code 3): bf16 q, e4m3 pool rows. On the tensor
// cores the producer warpgroup stages each tile's 1-byte rows and converts
// them to the bf16 swizzled tile (attn_tc::produce_staged, the fused K4's
// int8 staging); on the CUDA cores the row-block update widens 16 values a
// load. e4m3 -> bf16 is exact, so either gives the bf16 kernel's bits on
// the pool widened to bf16, and no widened pool is ever written.
//
// What bounds them on this card: operations. At the main path's shapes (K7:
// Hq 32, Hkv 8, d 128, a 3000-token causal prompt, 73.7 GFLOP against 61 MB
// of bf16 q, k, v and o, and the same at gemma-3's Hq 16, Hkv 4, d 256;
// K8: a 256-token chunk over a 2048-token prefix) the flops outweigh the
// bytes by far more than the card's ridge point, so the tensor cores are
// the resource.
//
// Design. The g query heads of a KV head are folded into one CTA's rows:
// rows = g * L, flattened (g, L) position-minor -- q's own memory layout --
// so a K/V tile is read once per row block instead of once per query head.
// Two kernels per entry point:
//   * bf16 at d 64 or 128, and K7 also at d 256 (gemma-3's head dim): the
//     tensor-core row-block kernel of attn_tc.cuh. A CTA of 128 rows, two
//     consumer warpgroups of 64 rows and a producer (at d 256: 64 rows, the
//     two warpgroups splitting O by columns, and K/V tiles of 64 keys --
//     attn_tc.cuh says why); K/V tiles of 128 keys come in through TMA (3-D
//     tensor maps encoded on
//     the host for each launch: K7 over k/v (B*Hkv, Lk, d), so rows past Lk
//     are zero-filled and never the next head's; K8 over the pool rows
//     (num_pages*Hkv, page, d), one copy per page at row tbl[n, jb]*Hkv + h)
//     into a 2-stage ring; QK^T and PV run on wgmma with the softmax in
//     registers; P goes through PV as two bf16 halves (p_hi + p_lo) into
//     one float32 accumulator, so the float32 contract of the plain version
//     holds to one bf16 step of the output. CTAs start in reverse row-block
//     order: the causal blocks at the end of the prompt, which walk the
//     most tiles, go first.
//   * float32, bf16 at other d (K8 at d 256 too: no engine path launches
//     it there), and K8 on a page that is not a multiple of 8 rows: the
//     CUDA-core kernel, K4's row-block update
//     (attn::rows_page_update, 64 rows a CTA, float32 tiles in shared
//     memory; a tile or page too large for them walked in sub-tiles, any
//     page size). Tensor cores on float32 would mean TF32, which breaks the
//     2e-5 float32 contract.
//
// Plain C interface (loaded with ctypes); each entry returns the launch's
// cudaError_t, or kEncodeError + the CUresult of a failed tensor-map
// encoding.

#include "attn_tc.cuh"
#include "attn_tile.cuh"

#include <limits.h>

#include <algorithm>

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
  int rows, Lq, Lk, d, tile, sub, causal, window, q_offset;
  float scale;
};

template <typename T, bool kWindow>
__global__ void __launch_bounds__(kRowThreads) flash_prefill_kernel(DenseArgs a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.sub);
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
      attn::rows_page_update<T, kWindow>(k + (size_t)k_start * d, v + (size_t)k_start * d, jmax,
                                         s, d, a.sub, a.scale);
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
  const size_t smem = attn::row_smem_bytes(a.d, a.sub);
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
  int n_kv, W, rows, chunk_cap, d, page, sub;
  float scale;
};

// Q: the queries' (and output's) type; KV: the pool rows' (Q, or e4m3).
template <typename Q, typename KV>
__global__ void __launch_bounds__(kRowThreads) flash_prefill_paged_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const RowSmem s = attn::carve_row_smem(smem_raw, a.d, a.sub);
  __shared__ int jmax_s;
  const int d = a.d, page = a.page, C = a.chunk_cap, ld = d + 1;
  const int nh = blockIdx.x, n = nh / a.n_kv, h = nh % a.n_kv;
  const int row0 = blockIdx.y * kBlockRows;
  const int nrows = min(kBlockRows, a.rows - row0);
  const size_t row_elems = (size_t)page * d;
  const KV* k_rows = static_cast<const KV*>(a.k_rows);
  const KV* v_rows = static_cast<const KV*>(a.v_rows);

  attn::reset_rows(s, d);
  attn::load_rows<Q>(static_cast<const Q*>(a.q) + ((size_t)nh * a.rows + row0) * d, nrows, s, d);
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
      attn::rows_page_update<KV>(k_rows + row * row_elems, v_rows + row * row_elems, jmax, s, d,
                                 a.sub, a.scale);
    }
  }
  __syncthreads();
  Q* out = static_cast<Q*>(a.out) + ((size_t)nh * a.rows + row0) * d;
  for (int e = threadIdx.x; e < nrows * d; e += kRowThreads) {
    const int r = e / d, c = e - r * d;
    attn::store(out + (size_t)r * d + c, s.acc[r * ld + c] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename Q, typename KV>
cudaError_t launch_typed(const Args& a, int num_rows, cudaStream_t stream) {
  auto kernel = flash_prefill_paged_kernel<Q, KV>;
  const size_t smem = attn::row_smem_bytes(a.d, a.sub);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_rows, (a.rows + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kRowThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------- tensor-core kernels (bf16)
using attn_tc::kKeys;
using attn_tc::kPanelBytes;
using attn_tc::kRows;
using attn_tc::kWgRows;

using attn_tc::encode_rows;
using attn_tc::pos_range;

struct DenseTcArgs {
  __nv_bfloat16* out;    // (B * n_kv, rows, d)
  int d, rows, Lq, Lk, causal, window, q_offset, num_rb;
  float scale_log2;      // scale * log2(e)
};

// K7 at head dim D: row block (num_rb - 1 - blockIdx.y) of kRowsCta rows of
// (batch row x KV head) blockIdx.x, over key tiles of KT keys.
template <int D>
struct DenseWalk {
  using Args = DenseTcArgs;
  static constexpr int KT = attn_tc::key_tile<D>();
  static constexpr int kRowsCta = attn_tc::cta_rows<D>();
  const Args a;
  int bh, row0, nrows, t0, ntiles, cta_lo, cta_hi;
  __nv_bfloat16* out;

  __device__ DenseWalk(const Args& args) : a(args) {
    bh = blockIdx.x;
    row0 = (a.num_rb - 1 - (int)blockIdx.y) * kRowsCta;
    nrows = min(kRowsCta, a.rows - row0);
    int pmin, pmax;
    pos_range(row0, nrows, a.Lq, pmin, pmax);
    cta_lo = a.window > 0 ? max(a.q_offset + pmin - a.window + 1, 0) : 0;
    cta_hi = a.causal ? min(max(a.q_offset + pmax + 1, 0), a.Lk) : a.Lk;
    t0 = cta_lo / KT;
    ntiles = cta_hi > cta_lo ? (cta_hi + KT - 1) / KT - t0 : 0;
    out = a.out + ((size_t)bh * a.rows + row0) * a.d;
  }
  __device__ int kbase(int t) const { return (t0 + t) * KT; }
  __device__ int nvalid(int) const { return KT; }
  __device__ void limits(int qpos, int& lo, int& hi) const {
    hi = a.causal ? min(max(qpos + 1, 0), a.Lk) : a.Lk;
    lo = a.window > 0 ? max(qpos - a.window + 1, 0) : 0;
  }
  __device__ void row_limits(int r, int& lo, int& hi) const {
    limits(a.q_offset + (row0 + r) % a.Lq, lo, hi);
  }
  __device__ void wg_limits(int c, int& lo, int& hi) const {
    const int n = min(kWgRows, a.rows - row0 - c * kWgRows);
    if (n <= 0) {  // no row of this warpgroup exists: nothing to mask
      lo = 0;
      hi = INT_MAX;
      return;
    }
    int pmin, pmax, unused;
    pos_range(row0 + c * kWgRows, n, a.Lq, pmin, pmax);
    limits(a.q_offset + pmin, unused, hi);   // least hi: the first position
    limits(a.q_offset + pmax, lo, unused);   // greatest lo: the last position
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, const CUtensorMap* qmap) const {
    const int panels = a.d / 64;
    constexpr uint32_t kQPanel = kRowsCta * 128;   // a 64-column panel of Q
    attn_tc::mbar_expect_tx(bar, panels * kQPanel);
    for (int p = 0; p < panels; ++p)
      attn_tc::tma_load_3d(dst + p * kQPanel, qmap, bar, p * 64, row0, bh);
  }
  __device__ void load_tile(int t, uint32_t kdst, uint32_t vdst, uint32_t kbar, uint32_t vbar,
                            const CUtensorMap* kmap, const CUtensorMap* vmap) const {
    const int panels = a.d / 64;
    constexpr uint32_t kPanel = KT * 128;   // a 64-column panel of a tile
    attn_tc::mbar_expect_tx(kbar, panels * kPanel);   // rows past Lk arrive as zeros
    attn_tc::mbar_expect_tx(vbar, panels * kPanel);
    for (int p = 0; p < panels; ++p)
      attn_tc::tma_load_3d(kdst + p * kPanel, kmap, kbar, p * 64, kbase(t), bh);
    for (int p = 0; p < panels; ++p)
      attn_tc::tma_load_3d(vdst + p * kPanel, vmap, vbar, p * 64, kbase(t), bh);
  }
};

// K8: row block (num_rb - 1 - blockIdx.y) of (pack row x KV head) blockIdx.x.
// A tile holds ppt whole pages (page <= 128) or 128 rows of one page
// (page > 128, tpp tiles a page).
struct PagedWalk {
  static constexpr int kRowsCta = kRows;
  struct Args {
    const int* tbl;        // (N, W)
    const int* q_off;      // (N,)
    __nv_bfloat16* out;    // (N * n_kv, rows, d)
    int d, n_kv, W, rows, chunk_cap, page, ppt, tpp, num_rb;
    float scale_log2;
  };
  const Args a;
  int n, h, row0, nrows, qoff, ntiles, cta_lo, cta_hi;
  __nv_bfloat16* out;

  __device__ PagedWalk(const Args& args) : a(args) {
    const int nh = blockIdx.x;
    n = nh / a.n_kv;
    h = nh % a.n_kv;
    row0 = (a.num_rb - 1 - (int)blockIdx.y) * kRows;
    nrows = min(kRows, a.rows - row0);
    qoff = a.q_off[n];
    out = a.out + ((size_t)nh * a.rows + row0) * a.d;
    int pmin, pmax;
    pos_range(row0, nrows, a.chunk_cap, pmin, pmax);
    const int max_qpos = qoff + pmax;
    cta_lo = 0;
    cta_hi = max_qpos + 1;
    const int np = max_qpos < 0 ? 0 : min(a.W, max_qpos / a.page + 1);   // pages walked
    if (np == 0)
      ntiles = 0;
    else if (a.page <= kKeys)
      ntiles = (np + a.ppt - 1) / a.ppt;
    else
      ntiles = (np - 1) * a.tpp + min(a.tpp, (max_qpos - (np - 1) * a.page) / kKeys + 1);
  }
  __device__ int kbase(int t) const {
    return a.page <= kKeys ? t * a.ppt * a.page : (t / a.tpp) * a.page + (t % a.tpp) * kKeys;
  }
  __device__ int nvalid(int t) const {
    return a.page <= kKeys ? min(a.ppt, a.W - t * a.ppt) * a.page
                           : min(kKeys, a.page - (t % a.tpp) * kKeys);
  }
  __device__ void row_limits(int r, int& lo, int& hi) const {
    lo = 0;
    hi = qoff + (row0 + r) % a.chunk_cap + 1;
  }
  __device__ void wg_limits(int c, int& lo, int& hi) const {
    const int nr = min(kWgRows, a.rows - row0 - c * kWgRows);
    lo = 0;
    if (nr <= 0) {
      hi = INT_MAX;
      return;
    }
    int pmin, pmax;
    pos_range(row0 + c * kWgRows, nr, a.chunk_cap, pmin, pmax);
    hi = qoff + pmin + 1;
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, const CUtensorMap* qmap) const {
    const int panels = a.d / 64;
    attn_tc::mbar_expect_tx(bar, panels * kPanelBytes);
    for (int p = 0; p < panels; ++p)
      attn_tc::tma_load_3d(dst + p * kPanelBytes, qmap, bar, p * 64, row0, n * a.n_kv + h);
  }
  __device__ void load_tile(int t, uint32_t kdst, uint32_t vdst, uint32_t kbar, uint32_t vbar,
                            const CUtensorMap* kmap, const CUtensorMap* vmap) const {
    const int panels = a.d / 64;
    const int* tbl = a.tbl + (size_t)n * a.W;
    if (a.page <= kKeys) {   // whole pages, one box of `page` rows each
      const int first = t * a.ppt, count = min(a.ppt, a.W - first);
      const uint32_t bytes = count * a.page * 128 * panels;
      attn_tc::mbar_expect_tx(kbar, bytes);
      attn_tc::mbar_expect_tx(vbar, bytes);
      for (int sub = 0; sub < count; ++sub) {
        const int row = tbl[first + sub] * a.n_kv + h;
        const uint32_t off = sub * a.page * 128;
        for (int p = 0; p < panels; ++p) {
          attn_tc::tma_load_3d(kdst + p * kPanelBytes + off, kmap, kbar, p * 64, 0, row);
          attn_tc::tma_load_3d(vdst + p * kPanelBytes + off, vmap, vbar, p * 64, 0, row);
        }
      }
    } else {   // 128 rows of one page; rows past the page arrive as zeros
      const int row = tbl[t / a.tpp] * a.n_kv + h, r0 = (t % a.tpp) * kKeys;
      attn_tc::mbar_expect_tx(kbar, panels * kPanelBytes);
      attn_tc::mbar_expect_tx(vbar, panels * kPanelBytes);
      for (int p = 0; p < panels; ++p) {
        attn_tc::tma_load_3d(kdst + p * kPanelBytes, kmap, kbar, p * 64, r0, row);
        attn_tc::tma_load_3d(vdst + p * kPanelBytes, vmap, vbar, p * 64, r0, row);
      }
    }
  }
  // e4m3 pools: tile t's 1-byte K and V rows, row-major (d bytes a row,
  // slot j at row j, as load_tile lays the bf16 tile), both completing on
  // bar; kmap and vmap from attn_tc::encode_bytes.
  __device__ void load_tile_bytes(int t, uint32_t kdst, uint32_t vdst, uint32_t bar,
                                  const CUtensorMap* kmap, const CUtensorMap* vmap) const {
    const int* tbl = a.tbl + (size_t)n * a.W;
    if (a.page <= kKeys) {   // whole pages, one box of `page` rows each
      const int first = t * a.ppt, count = min(a.ppt, a.W - first);
      attn_tc::mbar_expect_tx(bar, 2 * count * a.page * a.d);
      for (int sub = 0; sub < count; ++sub) {
        const int row = tbl[first + sub] * a.n_kv + h;
        const uint32_t off = sub * a.page * a.d;
        attn_tc::tma_load_3d(kdst + off, kmap, bar, 0, 0, row);
        attn_tc::tma_load_3d(vdst + off, vmap, bar, 0, 0, row);
      }
    } else {   // 128 rows of one page; rows past the page arrive as zeros
      const int row = tbl[t / a.tpp] * a.n_kv + h, r0 = (t % a.tpp) * kKeys;
      attn_tc::mbar_expect_tx(bar, 2 * kKeys * a.d);
      attn_tc::tma_load_3d(kdst, kmap, bar, 0, r0, row);
      attn_tc::tma_load_3d(vdst, vmap, bar, 0, r0, row);
    }
  }
};

template <int D, class Walk, bool kF8 = false>
cudaError_t launch_tc(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                      const typename Walk::Args& a, dim3 grid, cudaStream_t stream) {
  auto kernel = attn_tc::row_block_kernel<D, attn_tc::key_tile<D>(), Walk, kF8>;
  const size_t smem = kF8 ? attn_tc::smem_bytes_f8(D) : attn_tc::smem_bytes(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, attn_tc::kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

// K8: d 64 or 128, key tiles of 128; e4m3 pools with f8
int launch_paged_tc(int d, bool f8, const CUtensorMap& qm, const CUtensorMap& km,
                    const CUtensorMap& vm, const PagedWalk::Args& a, dim3 grid,
                    cudaStream_t stream) {
  switch (d) {
    case 64:
      return (int)(f8 ? launch_tc<64, PagedWalk, true>(qm, km, vm, a, grid, stream)
                      : launch_tc<64, PagedWalk>(qm, km, vm, a, grid, stream));
    case 128:
      return (int)(f8 ? launch_tc<128, PagedWalk, true>(qm, km, vm, a, grid, stream)
                      : launch_tc<128, PagedWalk>(qm, km, vm, a, grid, stream));
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7: d 64 or 128 (128 rows a CTA, key tiles of 128), d 256 (64 rows, 64)
int launch_dense_tc(int d, const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                    const DenseTcArgs& a, dim3 grid, cudaStream_t stream) {
  switch (d) {
    case 64: return (int)launch_tc<64, DenseWalk<64>>(qm, km, vm, a, grid, stream);
    case 128: return (int)launch_tc<128, DenseWalk<128>>(qm, km, vm, a, grid, stream);
    case 256: return (int)launch_tc<256, DenseWalk<256>>(qm, km, vm, a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
  const int sub = attn::row_sub_tile(d, tile);
  if (sub == 0) return (int)cudaErrorInvalidValue;
  DenseArgs a = {q, k, v, out, rows, Lq, Lk, d, tile, sub, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dense_typed<float>(a, num_bh, st);
    case 1: return (int)launch_dense_typed<__nv_bfloat16>(a, num_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8. dtype: 0 = float32, 1 = bfloat16 (q, the pools and the output share
// it), 3 = bf16 q and output with e4m3 pools (d a multiple of 16).
int flash_prefill_paged_launch(int dtype, const void* q, const void* k_rows, const void* v_rows,
                               const int* tbl, const int* q_off, void* out, int N, int n_kv,
                               int W, int rows, int chunk_cap, int d, int page, float scale,
                               void* stream) {
  if (N <= 0 || n_kv <= 0 || W <= 0 || rows <= 0 || chunk_cap <= 0 || d <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  const int sub = attn::row_sub_tile(d, page);
  if (sub == 0) return (int)cudaErrorInvalidValue;
  Args a = {q, k_rows, v_rows, tbl, q_off, out, n_kv, W, rows, chunk_cap, d, page, sub, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_typed<float, float>(a, N * n_kv, st);
    case 1: return (int)launch_typed<__nv_bfloat16, __nv_bfloat16>(a, N * n_kv, st);
    case 3:
      if (d % attn::kVec) return (int)cudaErrorInvalidValue;
      return (int)launch_typed<__nv_bfloat16, attn::e4m3>(a, N * n_kv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 on the tensor cores: bf16, d 64, 128 or 256; q, k, v 16-byte aligned.
int flash_prefill_tc_launch(const void* q, const void* k, const void* v, void* out, int num_bh,
                            int rows, int Lq, int Lk, int d, int causal, int window, int q_offset,
                            float scale, void* stream) {
  if (num_bh <= 0 || rows <= 0 || Lq <= 0 || Lk <= 0 || rows % Lq) return (int)cudaErrorInvalidValue;
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  const int kt = d == 256 ? attn_tc::key_tile<256>() : kKeys;
  const int cta = d == 256 ? attn_tc::cta_rows<256>() : kRows;
  CUtensorMap qm, km, vm;
  int err = encode_rows(&qm, q, d, rows, num_bh, cta);
  if (!err) err = encode_rows(&km, k, d, Lk, num_bh, kt);
  if (!err) err = encode_rows(&vm, v, d, Lk, num_bh, kt);
  if (err) return err;
  const int num_rb = (rows + cta - 1) / cta;
  DenseTcArgs a = {static_cast<__nv_bfloat16*>(out), d, rows, Lq, Lk, causal, window, q_offset,
                   num_rb, scale * 1.4426950408889634f};
  return launch_dense_tc(d, qm, km, vm, a, dim3(num_bh, num_rb),
                         static_cast<cudaStream_t>(stream));
}

// K8 on the tensor cores: bf16 q; dtype 1 = bf16 pools, 3 = e4m3 pools;
// d 64 or 128, page a multiple of 8.
int flash_prefill_paged_tc_launch(int dtype, const void* q, const void* k_rows,
                                  const void* v_rows, const int* tbl, const int* q_off, void* out,
                                  int N, int n_kv, int W, int rows, int chunk_cap, int d,
                                  int page, int num_pages, float scale, void* stream) {
  if (N <= 0 || n_kv <= 0 || W <= 0 || rows <= 0 || chunk_cap <= 0 || page <= 0 || page % 8 ||
      num_pages <= 0 || (dtype != 1 && dtype != 3))
    return (int)cudaErrorInvalidValue;
  const bool f8 = dtype == 3;
  CUtensorMap qm, km, vm;
  const int box = std::min(page, kKeys);
  const long long mats = (long long)num_pages * n_kv;
  int err = encode_rows(&qm, q, d, rows, (long long)N * n_kv, kRows);
  if (!err) err = f8 ? attn_tc::encode_bytes(&km, k_rows, d, page, mats, box)
                     : encode_rows(&km, k_rows, d, page, mats, box);
  if (!err) err = f8 ? attn_tc::encode_bytes(&vm, v_rows, d, page, mats, box)
                     : encode_rows(&vm, v_rows, d, page, mats, box);
  if (err) return err;
  const int num_rb = (rows + kRows - 1) / kRows;
  PagedWalk::Args a = {tbl, q_off, static_cast<__nv_bfloat16*>(out), d, n_kv, W, rows,
                       chunk_cap, page, std::max(1, kKeys / page), (page + kKeys - 1) / kKeys, num_rb,
                       scale * 1.4426950408889634f};
  return launch_paged_tc(d, f8, qm, km, vm, a, dim3(N * n_kv, num_rb),
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
