// Stream-K decode (K1, K2) for Hopper: the walk over device memory.
//
// Replaces, with lean_decode.cu, the Pallas TPU kernels of the reference:
//   K1  repro/kernels/lean_decode.py:117  _lean_decode_kernel (int8 body :135)
//   K2  repro/kernels/lean_decode.py:302  _lean_decode_fused_kernel (:321)
//
// A CTA walks its worker's columns and updates on each tile where it lies
// in device memory (attn::tile_update; int8 tiles staged by cp.async), for
// the shapes the decode ring of lean_decode.cu does not fit: the host passes
// ns = 0 where kernels/decode_ring.py gives no slots (float32 pages of 256,
// bf16 pages of 256 beside the 64-row bucket, rows whose bytes are not a
// multiple of 16).
// The arithmetic, the fix-up (lean_decode.cuh) and so the bits are the
// ring's; lean_decode.cu describes the design. Plain C interface (loaded
// with ctypes); the entry points return the cudaError_t of their launch.

#include "lean_decode.cuh"

namespace {

using namespace lean;
using attn::kThreads;

// Q: the queries' type; KV: the K/V rows' (Q, or int8_t with scales).
template <typename Q, typename KV, int QB, bool EXACT, bool FUSED>
__global__ void __launch_bounds__(kThreads) lean_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* stage = reinterpret_cast<int8_t*>(smem_raw);
  const Smem s = attn::carve_smem<QB>(
      reinterpret_cast<float*>(smem_raw + attn::stage_bytes<KV>(a.d, a.tile)), a.d, a.tile);
  __shared__ int merge_here;
  const int d = a.d, tile = a.tile, N = a.n_cols, gq = EXACT ? QB : a.gq;
  const Q* q = static_cast<const Q*>(a.q);
  const KV* k_rows = static_cast<const KV*>(a.k_rows);
  const KV* v_rows = static_cast<const KV*>(a.v_rows);
  const size_t row_elems = (size_t)tile * d;

  const int g = blockIdx.x;
  for (int t = 0; t < a.tiles_per_worker; ++t) {
    const int i = g * a.tiles_per_worker + t;
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) continue;  // padding column
    const int seg = a.desc[DESC_SEG * N + i];
    const int tile_idx = a.desc[DESC_TILE * N + i];
    const int piece = a.desc[DESC_PIECE * N + i];
    const bool first = a.desc[DESC_FIRST * N + i] != 0;
    const bool last = a.desc[DESC_LAST * N + i] != 0;

    if (first) attn::reset_decode_rows<QB>(s, d);  // Algorithm 1 lines 8-9
    attn::load_decode_q<Q, QB>(q + (size_t)seg * gq * d, gq, s, d);
    const int vlen = min(max(a.seg_ctx[seg] - tile_idx * tile, 0), tile);
    const size_t row = (size_t)a.route[i];
    float ks = 1.f, vs = 1.f;
    if constexpr (attn::is_int8<KV>) {
      ks = a.k_scales[row];
      vs = a.v_scales[row];
    }
    __syncthreads();

    attn::tile_update<KV, QB>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                              tile, a.scale, ks, vs, stage);

    if (last) finish_piece<FUSED, kThreads>(a, s, seg, piece, gq, &merge_here, ring::CtaSync());
    __syncthreads();  // shared state is reused by the next column
  }
}

// e4m3 rows have no walk: a 1-byte tile always leaves the ring two slots
// (kernels/decode_ring.py), so the host never asks for one.
template <typename Q, typename KV, int QB, bool EXACT, bool FUSED>
struct WalkKernel {
  static cudaError_t launch(const Args& a, int num_workers, int ns, cudaStream_t stream) {
    if constexpr (attn::is_f8<KV>) {
      return cudaErrorInvalidValue;
    } else {
      if (ns != 0) return cudaErrorInvalidValue;
      auto kernel = lean_decode_kernel<Q, KV, QB, EXACT, FUSED>;
      const size_t smem =
          attn::smem_bytes(QB, a.d, a.tile) + attn::stage_bytes<KV>(a.d, a.tile);
      if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
      }
      kernel<<<num_workers, kThreads, smem, stream>>>(a);
      return cudaGetLastError();
    }
  }
};

}  // namespace

// ns == 0.
LEAN_DECODE_ENTRY(WalkKernel)
