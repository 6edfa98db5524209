// Fixed-split (FlashDecoding) decode partials for Hopper: K6, the paper's
// baseline (section III-C).
//
// Replaces the Pallas TPU kernel of the reference:
//   K6  repro/kernels/flash_decode.py:25  _flash_decode_kernel
//       (driven by flash_decode_partials :92)
//
// The grid is (segment, split): every segment gets the same number of
// splits, each a fixed run of tps tiles, whatever its length. A CTA walks
// its split's tiles, skips tiles past the segment's runtime length (the
// reference's pl.when(vlen > 0)) and flushes the un-scaled (o, m, l) of its
// split; merge_n reduces the splits outside. A split with no visible key
// flushes m = -1e30, l = 0, which the merge weighs 0. That uniform split is
// the baseline's weakness the paper measures: with ragged lengths most
// CTAs of the short segments have nothing to do while the long segments'
// splits run their full tps tiles.
//
// What bounds it on this card: bytes -- decode at gq = 4 rows per KV head
// does far fewer flops than the ridge point asks per byte, so the floor is
// the visible K/V bytes over the HBM rate. But only the CTAs of the longest
// splits set the time, each on its own SM, so what counts is how fast one
// SM streams its split's tiles. A tile's visible K and V rows are
// contiguous in the dense (segment, tile) rows, so the CTA streams them
// through the bulk-copy ring of attn_decode_ring.cuh: a producer warp keeps
// the next tiles' K and V in flight into shared-memory slots while 256
// consumer threads run the decode update on the tile that has landed
// (ring::tile_update, the update K1, K2 and K5 run on their rings too),
// with attn::tile_update's arithmetic (the same bits). Where the ring does not
// fit (the host passes ns = 0: a float32 tile of 256 keys at d 128, rows
// whose bytes are not a multiple of 16) the CTA runs attn::tile_update
// on the tiles in device memory.
//
// f8 pools (dtype code 3): bf16 queries and e4m3 K/V rows, 1-byte tiles
// through the ring, widened to float32 as they are read (exact: the bf16
// form's bits on the rows widened to bf16). They always take the ring
// (the host's slot rule gives a 1-byte tile at least two slots), so they
// have no walk.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t.

#include "attn_decode_ring.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::Smem;

struct Args {
  const void* q;        // (S, gq, d)
  const void* k;        // (S * n_tiles, tile, d) dense rows, segment-major
  const void* v;
  const int* seg_ctx;   // (S,)
  float* o_p;           // (S, splits, gq, d)
  float* m_p;           // (S, splits, gq)
  float* l_p;
  int n_tiles, tps, gq, d, tile;
  float scale;
};

// GQ is the row bucket of gq (attn::row_bucket): rows gq..GQ-1 are zero
// queries whose results are never written, so a bucket equal to gq (the
// configs' g of 2 and 4) computes what the exact instantiation did.
// Q: the queries' type; KV: the K/V rows' (Q, or e4m3 on the ring).
template <typename Q, typename KV, int GQ>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const Smem s = attn::carve_smem<GQ>(smem_raw, a.d, a.tile);
  const int d = a.d, tile = a.tile, gq = a.gq;
  const int seg = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const Q* q = static_cast<const Q*>(a.q) + (size_t)seg * gq * d;
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const size_t row_elems = (size_t)tile * d;

  attn::load_decode_q<Q, GQ>(q, gq, s, d);
  attn::reset_decode_rows<GQ>(s, d);
  __syncthreads();
  const int ctx = a.seg_ctx[seg];
  for (int t = 0; t < a.tps; ++t) {
    const int tile_idx = split * a.tps + t;
    if (tile_idx >= a.n_tiles) break;
    const int vlen = min(max(ctx - tile_idx * tile, 0), tile);
    if (vlen == 0) continue;
    const size_t row = (size_t)seg * a.n_tiles + tile_idx;
    attn::tile_update<KV, GQ>(k + row * row_elems, v + row * row_elems, vlen, s, d, tile,
                              a.scale);
  }
  const size_t out = (size_t)seg * splits + split;
  attn::flush_rows(s, gq, d, a.o_p + out * gq * d, a.m_p + out * gq, a.l_p + out * gq);
}

// The same walk on the ring: the producer's lane copies each tile with work
// (K, then V), the consumers update on the staged rows.
template <typename Q, typename KV, int GQ>
__global__ void __launch_bounds__(ring::kThreads, 1) flash_decode_ring_kernel(Args a, int ns) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ uint64_t full[ring::kMaxSlots], empty[ring::kMaxSlots];
  const int d = a.d, tile = a.tile;
  const uint32_t slot = (uint32_t)ring::slot_bytes(sizeof(KV), d, tile);
  const ring::Ring r{ring_raw, slot, ns, full, empty};
  const Smem s = attn::carve_smem<GQ>(reinterpret_cast<float*>(ring_raw + (size_t)ns * slot), d,
                                      tile);
  const int seg = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int ctx = a.seg_ctx[seg];
  const size_t row_elems = (size_t)tile * d;
  if (threadIdx.x == 0) ring::init(r);
  __syncthreads();

  if (threadIdx.x >= ring::kConsumers) {  // the producer warp
    if (threadIdx.x != ring::kConsumers) return;
    const KV* k = static_cast<const KV*>(a.k);
    const KV* v = static_cast<const KV*>(a.v);
    int n = 0;
    for (int t = 0; t < a.tps; ++t) {
      const int tile_idx = split * a.tps + t;
      if (tile_idx >= a.n_tiles) break;
      const int vlen = min(max(ctx - tile_idx * tile, 0), tile);
      if (vlen == 0) continue;
      const size_t row = (size_t)seg * a.n_tiles + tile_idx;
      const uint32_t bytes = (uint32_t)(vlen * d * sizeof(KV));
      ring::acquire(r, n);
      ring::fill(r, n++, k + row * row_elems, bytes);
      ring::acquire(r, n);
      ring::fill(r, n++, v + row * row_elems, bytes);
    }
    return;
  }

  ring::cta_stamp(0);
  attn::load_decode_q<Q, GQ, ring::kConsumers>(static_cast<const Q*>(a.q) +
                                                   (size_t)seg * a.gq * d,
                                               a.gq, s, d);
  attn::reset_decode_rows<GQ, ring::kConsumers>(s, d);
  ring::sync_consumers();
  ring::QSlice<GQ> qs;
  qs.load(s, d);
  int n = 0;
  for (int t = 0; t < a.tps; ++t) {
    const int tile_idx = split * a.tps + t;
    if (tile_idx >= a.n_tiles) break;
    const int vlen = min(max(ctx - tile_idx * tile, 0), tile);
    if (vlen == 0) continue;
    ring::tile_update<KV, GQ>(r, n, vlen, s, qs, d, tile, a.scale, 1.f, 1.f);
    n += 2;
  }
  const size_t out = (size_t)seg * splits + split;
  attn::flush_rows<ring::kConsumers>(s, a.gq, d, a.o_p + out * a.gq * d, a.m_p + out * a.gq,
                                     a.l_p + out * a.gq);
  ring::cta_stamp(2);
}

template <typename Q, typename KV, int GQ>
cudaError_t launch_typed(const Args& a, int num_segments, int splits, int ns,
                         cudaStream_t stream) {
  const size_t state = attn::smem_bytes(GQ, a.d, a.tile);
  if (!ring::fits(ns, sizeof(KV), a.d, a.tile, state)) return cudaErrorInvalidValue;
  const dim3 grid(num_segments, splits);
  if (ns == 0) {
    if constexpr (attn::is_f8<KV>) {
      return cudaErrorInvalidValue;
    } else {
      auto kernel = flash_decode_kernel<Q, KV, GQ>;
      if (state > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state);
        if (err != cudaSuccess) return err;
      }
      kernel<<<grid, kThreads, state, stream>>>(a);
      return cudaGetLastError();
    }
  }
  auto kernel = flash_decode_ring_kernel<Q, KV, GQ>;
  const size_t smem = ns * ring::slot_bytes(sizeof(KV), a.d, a.tile) + state;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ring::kThreads, smem, stream>>>(a, ns);
  return cudaGetLastError();
}

// At the row bucket of gq: 2 (gq 1, 2), 4 (3, 4), 8 (5-8).
template <typename Q, typename KV>
cudaError_t launch_gq(const Args& a, int num_segments, int splits, int ns, cudaStream_t st) {
  switch (attn::row_bucket(a.gq)) {
    case 2: return launch_typed<Q, KV, 2>(a, num_segments, splits, ns, st);
    case 4: return launch_typed<Q, KV, 4>(a, num_segments, splits, ns, st);
    case 8: return launch_typed<Q, KV, 8>(a, num_segments, splits, ns, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it), 3 = bf16 q with
// e4m3 k and v (ring only: ns >= 2, d a multiple of 16). ns: slots of the
// ring (kernels/decode_ring.py), 0 for the walk over device memory; with
// ns > 0, k and v must be 16-byte aligned.
int flash_decode_partials_launch(int dtype, const void* q, const void* k, const void* v,
                                 const int* seg_ctx, float* o_p, float* m_p, float* l_p,
                                 int num_segments, int splits, int tps, int n_tiles, int gq,
                                 int d, int tile, float scale, int ns, void* stream) {
  if (num_segments <= 0 || splits <= 0 || tps <= 0 || n_tiles <= 0 || d <= 0 || tile <= 0 ||
      gq <= 0 || (ns > 0 && ((uintptr_t)k % 16 || (uintptr_t)v % 16)))
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, seg_ctx, o_p, m_p, l_p, n_tiles, tps, gq, d, tile, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_gq<float, float>(a, num_segments, splits, ns, st);
    case 1: return (int)launch_gq<__nv_bfloat16, __nv_bfloat16>(a, num_segments, splits, ns, st);
    case 3:
      if (d % attn::kVec) return (int)cudaErrorInvalidValue;
      return (int)launch_gq<__nv_bfloat16, attn::e4m3>(a, num_segments, splits, ns, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
