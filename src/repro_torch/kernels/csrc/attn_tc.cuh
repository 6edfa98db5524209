// Tensor-core row-block update for Hopper (sm_90a): the FA-2 inner loop of
// K7 and K8 (flash_prefill.cu) on wgmma and TMA; the fused K4
// (lean_prefill_tc.cu) runs the same per-tile step (tile_update) on its own
// stream-K walk, with int8 pages' scales applied to S and P. 1-byte K/V
// (int8, e4m3: the fused K4's int8 and f8 pages, K8's f8 pools) are staged
// by TMA and converted to the bf16 tile on the producer warpgroup
// (convert_tile, produce_staged).
//
// A CTA of kThreads = 384 threads serves kRows = 128 query rows of one
// (batch row, KV head): the folded (g, L) rows of q's own memory. Warpgroup 0
// is the producer: one thread issues every copy (Q once, then each key tile's
// K and V) with cp.async.bulk.tensor into 128-byte swizzled shared memory,
// completing on mbarriers, through a ring of kStages = 2 tiles of KT keys;
// setmaxnreg gives its registers to the consumers. Warpgroups 1 and 2 each
// own 64 of the rows and, per tile:
//   S = Q . K^T      wgmma m64nKTk16, Q and K from shared memory (K-major),
//                    float32 accumulators in registers;
//   mask, softmax    in registers, and the mask only on tiles that cross a
//                    row's [lo, hi) limits: the online-softmax update of
//                    attn_tile.cuh in base 2 (NEG_INF = -1e30 start, masked
//                    keys weigh exactly 0);
//   O += P . V       wgmma m64nDk16 with P from registers (the accumulator
//                    layout is the A-fragment layout) and V from shared
//                    memory (MN-major). P is split into two bf16 halves,
//                    p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both go
//                    through the tensor cores into the same float32
//                    accumulator, so p keeps about 16 significant bits where
//                    one bf16 copy keeps 8 (the reference keeps p in float32).
// Head dim 256 (col_split): the CTA serves 64 rows, and the two consumer
// warpgroups split O by columns -- each computes S and P for all 64 rows
// (the same values: QK^T is done twice) and O += P . V for its 128 of the
// 256 columns. A thread then holds O in 64 float32 registers, S for a
// 64-key tile (key_tile) in 32 and P's halves in 32, as at head dim 128:
// ptxas gives each of the block's 384 threads 168 registers, and O's 256
// columns a thread (128 float32) beside S and P spilled. Q
// (32 KB) and two stages of 64-key K and V tiles (4 x 32 KB) take 160
// KB of shared memory, where 128 rows and 128-key tiles would take 320 KB
// of a block's 227 KB.
//
// Keys no row of the CTA sees (past the causal limit, before the window,
// slots of a tile that hold no key) have their V rows zeroed in shared
// memory before P . V, so they add nothing, not even 0 * NaN. The flush
// writes acc / max(l, 1e-30): a row that sees no key writes 0.
//
// A walk (DenseWalk, PagedWalk in flash_prefill.cu) says where the CTA's
// rows and key tiles are:
//   Args                      its kernel arguments;
//   Walk(const Args&)         from blockIdx;
//   ntiles                    key tiles the CTA walks;
//   nrows, out                rows of the CTA that exist, and its first row
//                             of the output (row stride D);
//   cta_lo, cta_hi            every key some row of the CTA sees is in
//                             [cta_lo, cta_hi);
//   kbase(t), nvalid(t)       slot j < nvalid(t) of tile t holds key
//                             kbase(t) + j; the other slots hold no key;
//   row_limits(r, lo, hi)     row r of the CTA sees the keys [lo, hi);
//   wg_limits(c, lo, hi)      every row of consumer c sees every key in
//                             [lo, hi) (a tile inside it needs no mask);
//   load_q(dst, bar, map)     the producer's copies of Q;
//   load_tile(t, kdst, vdst, kbar, vbar, kmap, vmap)
//                             the producer's copies of tile t's K and V.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tc {

constexpr int kRows = 128;          // query rows of a CTA
constexpr int kWgRows = 64;         // rows of one consumer warpgroup
constexpr int kKeys = 128;          // keys of a tile at head dim 64 and 128
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;          // K/V tiles in flight
constexpr int kPanelBytes = 128 * 128;   // 128 rows of a 64-column bf16 panel
constexpr float kNegInf = -1e30f;   // finite start of the running max, as the reference
constexpr int kStageBar = 4;        // named barrier of the producer warpgroup (1-byte staging)

// Head dim 256: the consumers split O by columns over 64 rows a CTA.
template <int D>
__host__ __device__ constexpr bool col_split() {
  return D == 256;
}

// Query rows of a CTA, and keys of a tile, of the row block at head dim D.
template <int D>
__host__ __device__ constexpr int cta_rows() {
  return col_split<D>() ? kWgRows : kRows;
}
template <int D>
__host__ __device__ constexpr int key_tile() {
  return col_split<D>() ? 64 : kKeys;
}

// Dynamic shared memory of the kernel for head dim d (64, 128 or 256): Q
// (cta_rows rows), then the K ring, then the V ring (key_tile rows a tile),
// each d / 64 panels wide, plus alignment: 160 KB at d 128 and at d 256.
inline size_t smem_bytes(int d) {
  const int rows = d == 256 ? cta_rows<256>() : kRows, kt = d == 256 ? key_tile<256>() : kKeys;
  return (size_t)(d / 64) * 128 * (rows + 2 * kStages * kt) + 1024;
}

// Positions (r % L) of the rows [r0, r0 + n), n > 0: their least and
// greatest (a block that wraps past L holds 0 and L - 1).
__device__ __forceinline__ void pos_range(int r0, int n, int L, int& lo, int& hi) {
  const int a = r0 % L;
  if (a + n <= L) {
    lo = a;
    hi = a + n - 1;
  } else {
    lo = 0;
    hi = L - 1;
  }
}

// ------------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed. A pipeline fault
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// Box of a 3-D tensor map at (c0, c1, c2), innermost first, into shared
// memory; completes on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (Q, K):
// 8-row groups 1024 bytes apart (SBO), LBO unused. MN-major (V): 8 keys a
// group 1024 bytes apart (SBO), the next 64 columns one panel on (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ------------------------------------------------------------------ wgmma
// S (+)= A . B, both from shared memory (K-major): m64n128k16, bf16 -> float32
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= A . B, both from shared memory (K-major): m64n64k16, bf16 -> float32
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= Q . K^T over one key tile of KT keys
template <int KT>
__device__ __forceinline__ void wgmma_qk(float (&s)[KT / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (KT == 128) {
    wgmma_ss_n128(s, da, db, scale_d);
  } else {
    wgmma_ss_n64(s, da, db, scale_d);
  }
}

// D += A . B, A (bf16 fragments) from registers, B from shared memory (MN-major):
// m64n128k16, bf16 -> float32
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D += A . B, A (bf16 fragments) from registers, B from shared memory (MN-major):
// m64n64k16, bf16 -> float32
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


// O += P . V for one k-step of 16 keys whose V rows start at vrow, over DO
// columns (64 or 128); the 64-column panels of a V tile lie vpanel bytes
// apart.
template <int DO>
__device__ __forceinline__ void wgmma_pv(float (&o)[DO / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t vrow, uint32_t vpanel) {
  if constexpr (DO == 128) {
    wgmma_rs_n128(o, a0, a1, a2, a3, sw128_desc(vrow, vpanel, 1024));
  } else {
    wgmma_rs_n64(o, a0, a1, a2, a3, sw128_desc(vrow, vpanel, 1024));
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------ 1-byte tiles -> bf16
// int8 and e4m3 K/V pages reach wgmma as bf16: TMA stages the 1-byte tile
// (row-major, D bytes a row) and the producer warpgroup converts it into
// the bf16 swizzled tile, exactly (both types' values are bf16 values).

// Two int8 values (bytes k and k + 1 of w) as bf16x2. x + 128 goes into
// the mantissa of 2^23 (a byte permute), 2^23 + 128 comes off (exact), and
// since an integer of at most 8 significant bits is exact in bf16, the top
// halves of the two float32s are the bf16 pair: no conversion instruction.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int k) {
  const uint32_t u = w ^ 0x80808080u;   // each byte x + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (k + 1))) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Two e4m3 values (bytes k and k + 1 of w) as bf16x2: e4m3 -> f16 (the
// card's paired conversion) -> float32 -> bf16, each step exact (4
// significant bits, exponents inside both types' ranges); NaN stays NaN.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t w, int k) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> (8 * k)), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return bf16x2_bits(__floats2bfloat162_rn(f.x, f.y));
}

template <bool kF8>
__device__ __forceinline__ uint32_t byte2_to_bf16x2(uint32_t w, int k) {
  if constexpr (kF8)
    return e4m3x2_to_bf16x2(w, k);
  else
    return int8x2_to_bf16x2(w, k);
}

// Rows [0, nr) of a staged 1-byte tile (row-major, D bytes a row; e4m3
// with kF8, else int8) into the bf16 swizzled tile at dst, on the 128
// threads of the producer warpgroup (ptid 0..127): 8 values (one 16-byte
// chunk of bf16) a step.
template <int D, bool kF8>
__device__ __forceinline__ void convert_tile(uint32_t src, uint32_t dst, int nr, int ptid) {
  constexpr int kChunks = D / 8;   // 16-byte bf16 chunks a row
#pragma unroll 2
  for (int e = ptid; e < nr * kChunks; e += 128) {
    const int r = e / kChunks, c8 = e % kChunks;
    uint32_t w0, w1;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w0), "=r"(w1)
                 : "r"(src + r * D + c8 * 8));
    const uint32_t h[4] = {byte2_to_bf16x2<kF8>(w0, 0), byte2_to_bf16x2<kF8>(w0, 2),
                           byte2_to_bf16x2<kF8>(w1, 0), byte2_to_bf16x2<kF8>(w1, 2)};
    const int chunk = c8 % 8;
    const uint32_t at = dst + (c8 / 8) * kPanelBytes + r * 128 + ((chunk ^ (r & 7)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(h[0]), "r"(h[1]),
                 "r"(h[2]), "r"(h[3])
                 : "memory");
  }
}

// -------------------------------------------------------------- producer
template <int D, int KT, class Walk>
__device__ __forceinline__ void produce(const Walk& w, uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                        uint32_t bar0, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap) {
  constexpr uint32_t kTile = (D / 64) * KT * 128;
  w.load_q(q_s, bar0, qmap);
  for (int t = 0; t < w.ntiles; ++t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(bar0 + 8 * (5 + s), ((t / kStages) - 1) & 1);
    w.load_tile(t, k_s + s * kTile, v_s + s * kTile, bar0 + 8 * (1 + s), bar0 + 8 * (3 + s),
                kmap, vmap);
  }
}

// e4m3 K/V (K8 on the f8 pools): thread 0 issues Q and each tile's 1-byte
// K and V rows into a 2-stage staging ring, two tiles ahead, through the
// walk's load_tile_bytes (completing on the staging barriers that follow
// the stage-empty ones); the whole producer warpgroup converts a landed
// tile into the bf16 ring stage once the consumers have freed it (exact),
// then thread 0 marks its K and V full, one arrival each. The consumers
// run the bf16 tile update unchanged.
template <int D, int KT, class Walk>
__device__ __forceinline__ void produce_staged(const Walk& w, uint32_t q_s, uint32_t k_s,
                                               uint32_t v_s, uint32_t st_s, uint32_t bar0,
                                               const CUtensorMap* qmap, const CUtensorMap* kmap,
                                               const CUtensorMap* vmap) {
  constexpr uint32_t kTile = (D / 64) * KT * 128;
  constexpr uint32_t kStTile = KT * D;   // one 1-byte tile
  const uint32_t st_bar = bar0 + 8 * (1 + 3 * kStages);
  const int ptid = threadIdx.x;
  int issued = 0;   // thread 0's issue cursor
  auto issue = [&]() {
    if (issued >= w.ntiles) return;
    const uint32_t dst = st_s + (issued % kStages) * 2 * kStTile;
    w.load_tile_bytes(issued, dst, dst + kStTile, st_bar + 8 * (issued % kStages), kmap, vmap);
    ++issued;
  };
  if (ptid == 0) {
    w.load_q(q_s, bar0, qmap);
    issue();
    issue();
  }
  for (int t = 0; t < w.ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(st_bar + 8 * s, (t / kStages) & 1);
    if (t >= kStages) mbar_wait(bar0 + 8 * (5 + s), ((t / kStages) - 1) & 1);
    const uint32_t src = st_s + s * 2 * kStTile;
    const int nr = w.nvalid(t);
    convert_tile<D, true>(src, k_s + s * kTile, nr, ptid);
    convert_tile<D, true>(src + kStTile, v_s + s * kTile, nr, ptid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"n"(kStageBar) : "memory");
    if (ptid == 0) {
      mbar_arrive(bar0 + 8 * (1 + s));
      mbar_arrive(bar0 + 8 * (3 + s));
      issue();   // staging stage s is free again
    }
  }
}

// -------------------------------------------------------------- consumer
// One key tile (KT keys) of a consumer warpgroup's 64 rows: S = Q . K^T, the mask,
// the online-softmax update of (o, m, l) and O += P . V over DO of the D
// columns (D; or, under col_split, consumer c's half: the V panels from
// c * DO / 64 on, and Q in panels of 64 rows), for the tile in
// ring stage (kt, vt) whose K and V complete on kbar / vbar at parity par.
// Slot j < nv of the tile holds key kb + j; this thread's rows rA, rA + 8
// see the keys [lo[i], hi[i]); every row of the warpgroup sees [wg_lo,
// wg_hi); no row of the CTA sees a key outside [cta_lo, cta_hi), so those
// V rows are zeroed. kScaled (int8 K/V converted to bf16 as they are): the
// scores are multiplied by k_scale before the mask and the base-2 scale,
// and P by v_scale before its bf16 split; l sums the unscaled p.
template <int D, bool kScaled, int KT = kKeys, int DO = D>
__device__ __forceinline__ void tile_update(float (&o)[DO / 2], float (&m)[2], float (&l)[2],
                                            uint32_t q_wg, uint32_t kt, uint32_t vt,
                                            uint32_t kbar, uint32_t vbar, uint32_t par, int kb,
                                            int nv, const int (&lo)[2], const int (&hi)[2],
                                            int wg_lo, int wg_hi, int cta_lo, int cta_hi,
                                            float scale_log2, float k_scale, float v_scale) {
  constexpr bool kSplit = DO != D;
  constexpr int P = DO / 64;                 // V panels this warpgroup reads
  constexpr int kO = DO / 2;
  constexpr int kS = KT / 2;                 // S accumulators per thread
  constexpr int kNb = KT / 8;                // 8-key column blocks of S
  constexpr uint32_t kVPanel = KT * 128;     // bytes of a 64-column panel of a K/V tile
  constexpr uint32_t kQPanel = (kSplit ? kWgRows : kRows) * 128;   // of Q
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, lane = tid % 32;

  // S = Q . K^T
  float sc[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) sc[i] = 0.f;
  mbar_wait(kbar, par);
  wg_fence();
  fence_regs(sc);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_qk<KT>(sc, sw128_desc(q_wg + (kk / 4) * kQPanel + col, 16, 1024),
                 sw128_desc(kt + (kk / 4) * kVPanel + col, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(sc);
  if constexpr (kScaled) {
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] *= k_scale;
  }

  // mask, only on tiles that cross a limit of some row of this warpgroup
  if (!(nv == KT && kb >= wg_lo && kb + KT <= wg_hi)) {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nb * 8 + (lane % 4) * 2 + (e & 1), i = e >> 1;
        if (!(j < nv && kb + j >= lo[i] && kb + j < hi[i]))
          sc[nb * 4 + e] = __int_as_float(0xff800000);   // -inf: weighs exactly 0
      }
  }

  // online softmax in base 2: m, l, alpha per row; p in registers
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = __int_as_float(0xff800000);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) mx = fmaxf(mx, fmaxf(sc[nb * 4 + 2 * i], sc[nb * 4 + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
  }
  // P split into bf16 halves, laid out as wgmma A fragments: k-step ks
  // (keys 16 ks .. 16 ks + 15) is registers 4 ks .. 4 ks + 3
  uint32_t ph[KT / 4], pl[KT / 4];
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p0 = exp2f(fmaf(sc[nb * 4 + 2 * i], scale_log2, -m[i]));
      float p1 = exp2f(fmaf(sc[nb * 4 + 2 * i + 1], scale_log2, -m[i]));
      rsum[i] += p0 + p1;
      if constexpr (kScaled) {
        p0 *= v_scale;
        p1 *= v_scale;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(h);
      const int reg = 4 * (nb / 2) + 2 * (nb % 2) + i;
      ph[reg] = bf16x2_bits(h);
      pl[reg] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rsum[i];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];

  // V: zero the rows of keys no row of the CTA sees, then O += P . V
  mbar_wait(vbar, par);
  if constexpr (kSplit) vt += c * P * kVPanel;
  const int jlo = min(max(cta_lo - kb, 0), nv), jhi = min(max(cta_hi - kb, 0), nv);
  if (jlo > 0 || jhi < KT) {
    const int nz = jlo + (KT - jhi);
    for (int e = tid; e < nz * P * 8; e += 128) {
      const int chunk = e % 8, rp = e / 8, p = rp % P, zr = rp / P;
      const int row = zr < jlo ? zr : jhi + (zr - jlo);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       vt + p * kVPanel + row * 128 + chunk * 16),
                   "r"(0), "r"(0), "r"(0), "r"(0)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  }
  wg_fence();
  fence_regs(o);
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks)
    wgmma_pv<DO>(o, ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3],
                 vt + ks * 16 * 128, kVPanel);
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks)
    wgmma_pv<DO>(o, pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3],
                 vt + ks * 16 * 128, kVPanel);
  wg_commit();
  wg_wait_all();
  fence_regs(o);
}

template <int D, int KT, class Walk>
__device__ __forceinline__ void consume(const Walk& w, uint32_t q_s, uint32_t k_s, uint32_t v_s,
                                        uint32_t bar0, float scale_log2) {
  constexpr uint32_t kTile = (D / 64) * KT * 128;
  constexpr bool kSplit = col_split<D>();
  constexpr int DO = kSplit ? D / 2 : D;    // output columns of this warpgroup
  constexpr int kO = DO / 2;                // output accumulators per thread
  const int c = threadIdx.x / 128 - 1;      // consumer 0 or 1
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int wg = kSplit ? 0 : c;            // this warpgroup's 64 rows of the CTA
  // this thread's rows of the CTA: rA and rA + 8 (the wgmma fragment layout)
  const int rA = wg * kWgRows + warp * 16 + lane / 4;
  int lo[2], hi[2];
  w.row_limits(rA, lo[0], hi[0]);
  w.row_limits(rA + 8, lo[1], hi[1]);
  int wg_lo, wg_hi;
  w.wg_limits(wg, wg_lo, wg_hi);
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in units of log2
  const uint32_t q_wg = q_s + wg * kWgRows * 128;
  mbar_wait(bar0, 0);

  for (int t = 0; t < w.ntiles; ++t) {
    const int s = t % kStages;
    tile_update<D, false, KT, DO>(o, m, l, q_wg, k_s + s * kTile, v_s + s * kTile,
                                  bar0 + 8 * (1 + s), bar0 + 8 * (3 + s), (t / kStages) & 1,
                                  w.kbase(t), w.nvalid(t), lo, hi, wg_lo, wg_hi, w.cta_lo,
                                  w.cta_hi, scale_log2, 1.f, 1.f);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (5 + s));   // this warp is done with the stage
  }

  // flush: acc / max(l, 1e-30), rows the CTA has
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rA + 8 * i;
    if (r < w.nrows) {
      __nv_bfloat16* dst = w.out + (size_t)r * D + (kSplit ? c * DO : 0) + (lane % 4) * 2;
#pragma unroll
      for (int nb = 0; nb < DO / 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * 8) =
            __floats2bfloat162_rn(o[nb * 4 + 2 * i] / l[i], o[nb * 4 + 2 * i + 1] / l[i]);
    }
  }
}

// ------------------------------------------------------------ tensor maps
constexpr int kEncodeError = 100000;   // + the CUresult of a failed encoding

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over rows of d elements, (d, n_rows, n_mats) innermost first,
// boxes of box_cols x box_rows x 1; reads outside the tensor fill zeros.
// Returns 0, cudaErrorNotSupported or kEncodeError + the CUresult.
inline int encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     CUtensorMapSwizzle swizzle, const void* base, int d, long long n_rows,
                     long long n_mats, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n_rows, (cuuint64_t)n_mats};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem_bytes,
                                 (cuuint64_t)n_rows * d * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// bf16 rows in 64-column boxes, 128-byte swizzle: what wgmma reads
inline int encode_rows(CUtensorMap* map, const void* base, int d, long long n_rows,
                       long long n_mats, int box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_128B, base, d,
                   n_rows, n_mats, 64, box_rows);
}

// 1-byte rows (int8, e4m3) in whole-row boxes, no swizzle: the staging
// layout convert_tile reads
inline int encode_bytes(CUtensorMap* map, const void* base, int d, long long n_rows,
                        long long n_mats, int box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_NONE, base, d,
                   n_rows, n_mats, d, box_rows);
}

// Dynamic shared memory of the kernel with e4m3 K/V: smem_bytes plus the
// staging ring of 1-byte K and V tiles (230,400 bytes at d 128).
inline size_t smem_bytes_f8(int d) {
  const int kt = d == 256 ? key_tile<256>() : kKeys;
  return smem_bytes(d) + (size_t)kStages * 2 * kt * d;
}

// ------------------------------------------------------------------ kernel
// kF8: the K/V maps are over e4m3 rows (encode_bytes), staged and
// converted by the producer warpgroup (produce_staged; the walk provides
// load_tile_bytes).
template <int D, int KT, class Walk, bool kF8 = false>
__global__ void __launch_bounds__(kThreads, 1)
    row_block_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const typename Walk::Args a) {
  static_assert(KT == key_tile<D>() && Walk::kRowsCta == cta_rows<D>() &&
                    (D == 64 || D == 128 || D == 256),
                "head dim 64 or 128 with 128 rows and 128-key tiles, 256 with 64 and 64");
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q, K full [2], V full [2], stage empty [2], and with kF8
  // staging full [2]
  __shared__ __align__(8) uint64_t bars[1 + (kF8 ? 4 : 3) * kStages];
  constexpr uint32_t kTile = (D / 64) * KT * 128;
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + (D / 64) * cta_rows<D>() * 128;
  const uint32_t v_s = k_s + kStages * kTile;
  const uint32_t bar0 = smem_u32(bars);
  const Walk w(a);
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * (1 + s), 1);
      mbar_init(bar0 + 8 * (3 + s), 1);
      mbar_init(bar0 + 8 * (5 + s), 8);   // one arrival per consumer warp
      if constexpr (kF8) mbar_init(bar0 + 8 * (7 + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if constexpr (kF8)
      produce_staged<D, KT>(w, q_s, k_s, v_s, v_s + kStages * kTile, bar0, &qmap, &kmap, &vmap);
    else if (threadIdx.x == 0)
      produce<D, KT>(w, q_s, k_s, v_s, bar0, &qmap, &kmap, &vmap);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, KT>(w, q_s, k_s, v_s, bar0, a.scale_log2);
  }
}

}  // namespace attn_tc
