// Fixed-split (FlashDecoding) decode partials for Hopper: K6, the paper's
// baseline (section III-C).
//
// Replaces the Pallas TPU kernel of the reference:
//   K6  repro/kernels/flash_decode.py:25  _flash_decode_kernel
//       (driven by flash_decode_partials :92)
//
// The grid is (segment, split): every segment gets the same number of
// splits, each a fixed run of tps tiles, whatever its length. A CTA walks
// its split's tiles with the decode tile update K1 and K2 share
// (attn::tile_update), skips tiles past the segment's runtime length (the
// reference's pl.when(vlen > 0)) and flushes the un-scaled (o, m, l) of its
// split; merge_n reduces the splits outside. A split with no visible key
// flushes m = -1e30, l = 0, which the merge weighs 0. That uniform split is
// the baseline's weakness the paper measures: with ragged lengths most
// CTAs of the short segments have nothing to do while the long segments'
// splits run their full tps tiles.
//
// What bounds it on this card: the same as K1/K2 -- decode at gq = 4 rows
// per KV head does far fewer flops than the ridge point asks per byte, so
// the floor is the visible K/V bytes over the HBM rate. K/V are read once,
// straight from the dense (segment, tile) rows.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t.

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::Smem;

struct Args {
  const void* q;        // (S, GQ, d)
  const void* k;        // (S * n_tiles, tile, d) dense rows, segment-major
  const void* v;
  const int* seg_ctx;   // (S,)
  float* o_p;           // (S, splits, GQ, d)
  float* m_p;           // (S, splits, GQ)
  float* l_p;
  int n_tiles, tps, d, tile;
  float scale;
};

template <typename T, int GQ>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const Smem s = attn::carve_smem<GQ>(smem_raw, a.d, a.tile);
  const int d = a.d, tile = a.tile;
  const int seg = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const T* q = static_cast<const T*>(a.q) + (size_t)seg * GQ * d;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t row_elems = (size_t)tile * d;

  for (int e = threadIdx.x; e < GQ * d; e += kThreads) {
    s.q[e] = attn::to_float(q[e]);
    s.acc[e] = 0.f;
  }
  if (threadIdx.x < GQ) {
    s.m[threadIdx.x] = kNegInf;
    s.l[threadIdx.x] = 0.f;
  }
  __syncthreads();
  const int ctx = a.seg_ctx[seg];
  for (int t = 0; t < a.tps; ++t) {
    const int tile_idx = split * a.tps + t;
    if (tile_idx >= a.n_tiles) break;
    const int vlen = min(max(ctx - tile_idx * tile, 0), tile);
    if (vlen == 0) continue;
    const size_t row = (size_t)seg * a.n_tiles + tile_idx;
    attn::tile_update<T, GQ>(k + row * row_elems, v + row * row_elems, vlen, s, d, tile,
                             a.scale);
  }
  const size_t out = (size_t)seg * splits + split;
  for (int e = threadIdx.x; e < GQ * d; e += kThreads) a.o_p[out * GQ * d + e] = s.acc[e];
  if (threadIdx.x < GQ) {
    a.m_p[out * GQ + threadIdx.x] = s.m[threadIdx.x];
    a.l_p[out * GQ + threadIdx.x] = s.l[threadIdx.x];
  }
}

template <typename T, int GQ>
cudaError_t launch_typed(const Args& a, int num_segments, int splits, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, GQ>;
  const size_t smem = attn::smem_bytes(GQ, a.d, a.tile);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(num_segments, splits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gq(const Args& a, int gq, int num_segments, int splits, cudaStream_t st) {
  switch (gq) {
    case 2: return launch_typed<T, 2>(a, num_segments, splits, st);
    case 4: return launch_typed<T, 4>(a, num_segments, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).
int flash_decode_partials_launch(int dtype, const void* q, const void* k, const void* v,
                                 const int* seg_ctx, float* o_p, float* m_p, float* l_p,
                                 int num_segments, int splits, int tps, int n_tiles, int gq,
                                 int d, int tile, float scale, void* stream) {
  if (num_segments <= 0 || splits <= 0 || tps <= 0 || n_tiles <= 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, seg_ctx, o_p, m_p, l_p, n_tiles, tps, d, tile, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_gq<float>(a, gq, num_segments, splits, st);
    case 1: return (int)launch_gq<__nv_bfloat16>(a, gq, num_segments, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
