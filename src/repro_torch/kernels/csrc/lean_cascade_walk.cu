// Fused cascade decode (K5) for Hopper: the walk over device memory.
//
// Replaces, with lean_cascade.cu, the Pallas TPU kernel of the reference:
//   K5  repro/kernels/lean_decode.py:604  _lean_cascade_fused_kernel
//       (int8 body :628)
//
// K5's CTA walks its worker's columns and updates on each tile where it
// lies in device memory (attn::tile_update; int8 tiles staged by
// cp.async), for the shapes the decode ring of lean_cascade.cu does not
// fit: the host passes ns = 0 where kernels/decode_ring.py gives no slots
// (a float32 page of 256 keys, a bf16 page of 256 beside the 64-row bucket,
// rows whose bytes are not a multiple of 16). The arithmetic, the fix-up
// (lean_cascade.cuh) and so the bits are the ring's; lean_cascade.cu
// describes the design. Plain C interface (loaded with ctypes); the entry
// point returns the cudaError_t of its launch.

// g of 1 to 4 only: the ring (lean_cascade.cu) takes g up to 8
#define CASCADE_MAX_GB 4
#include "lean_cascade.cuh"

namespace {

using namespace cascade;
using attn::kThreads;

// Q: the queries' type; KV: the K/V rows' (Q, or int8_t with scales).
template <typename Q, typename KV, int GB, int QB>
__global__ void __launch_bounds__(kThreads) lean_cascade_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* stage = reinterpret_cast<int8_t*>(smem_raw);
  const Smem s = attn::carve_smem<QB>(
      reinterpret_cast<float*>(smem_raw + attn::stage_bytes<KV>(a.d, a.tile)), a.d, a.tile);
  __shared__ int merge_list[kMaxTargets];
  __shared__ int n_merge;
  const int d = a.d, tile = a.tile, N = a.n_desc;
  const KV* k_rows = static_cast<const KV*>(a.k_rows);
  const KV* v_rows = static_cast<const KV*>(a.v_rows);
  const size_t row_elems = (size_t)tile * d;
  const int w = blockIdx.x;

  for (int t = 0; t < a.tp + a.ts; ++t) {
    // the worker's prefix columns, then its suffix columns
    const int i = t < a.tp ? w * a.tp + t : a.n_pref + w * a.ts + (t - a.tp);
    if (a.desc[DESC_VALID * N + i] != OP_PARTIAL) continue;  // padding column
    const int seg = a.desc[DESC_SEG * N + i];
    const int tile_idx = a.desc[DESC_TILE * N + i];
    const int piece = a.desc[DESC_PIECE * N + i];
    const bool first = a.desc[DESC_FIRST * N + i] != 0;
    const bool last = a.desc[DESC_LAST * N + i] != 0;
    const bool prefix = seg < a.nph;
    const int rows = prefix ? a.qmax : a.g;

    if (prefix) {
      if (first) attn::reset_decode_rows<QB>(s, d);
      attn::load_decode_q<Q, QB>(static_cast<const Q*>(a.q_pref) + (size_t)seg * a.qmax * d,
                                 rows, s, d);
    } else {
      if (first) attn::reset_decode_rows<GB>(s, d);
      attn::load_decode_q<Q, GB>(
          static_cast<const Q*>(a.q_suf) + (size_t)(seg - a.nph) * a.g * d, rows, s, d);
    }
    const int vlen = min(max(a.ctx_all[seg] - tile_idx * tile, 0), tile);
    const size_t row = (size_t)a.route[i];
    float ks = 1.f, vs = 1.f;
    if constexpr (attn::is_int8<KV>) {
      ks = a.k_scales[row];
      vs = a.v_scales[row];
    }
    __syncthreads();

    if (prefix)
      attn::tile_update<KV, QB>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                                tile, a.scale, ks, vs, stage);
    else
      attn::tile_update<KV, GB>(k_rows + row * row_elems, v_rows + row * row_elems, vlen, s, d,
                                tile, a.scale, ks, vs, stage);

    if (last) finish_piece<kThreads>(a, s, piece, rows, merge_list, &n_merge, ring::CtaSync());
    __syncthreads();  // shared state is reused by the next column
  }
}

template <typename Q, typename KV, int GB, int QB>
struct WalkKernel {
  static cudaError_t launch(const Args& a, int num_workers, int ns, cudaStream_t stream) {
    // (e4m3 rows have no walk: their 1-byte tiles always fit the ring)
    if constexpr (QB < GB || attn::is_f8<KV>) {  // the stacked rows are at least one member's g
      return cudaErrorInvalidValue;
    } else {
      if (ns != 0) return cudaErrorInvalidValue;
      auto kernel = lean_cascade_kernel<Q, KV, GB, QB>;
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
LEAN_CASCADE_ENTRY(WalkKernel)
