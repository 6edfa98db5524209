// The decode tile walk on a ring of shared-memory copies: K6
// (flash_decode.cu) and K5 (lean_cascade.cu).
//
// attn::tile_update reads each K/V tile from device memory inside its
// compute phases, so a CTA keeps only a few keys per warp in flight and
// loads nothing for the next tile while this one computes. A decode CTA
// runs alone on its SM; that walk moved about 2.5 GB/s per CTA (K6 on the
// H100) against the ~25 GB/s an SM's share of HBM allows.
//
// Here a CTA is kConsumers threads that compute plus one producer warp
// whose first lane issues every copy. Each copy is one K or V tile's
// visible rows -- contiguous in device memory, so one 1-D bulk copy
// (cp.async.bulk, the TMA's plain form, no tensor map) of vlen * d *
// sizeof(T) bytes -- into the next slot of a ring of `ns` shared-memory
// slots, completing on that slot's `full` mbarrier with expect_tx. A walk
// issues its copies in order, K of a tile then its V; copy n lands in slot
// n % ns. The consumers wait on `full`, run the three phases of the decode
// update (attn::decode_scores, decode_softmax, decode_pv: the arithmetic
// of attn::tile_update, on the staged rows) and release the K slot after
// phase A and the V slot after phase C, by one arrival on the slot's
// `empty` mbarrier, which the producer waits on before it fills the slot
// again. So up to ns copies -- ns / 2 tiles -- are in flight while the
// consumers compute, and a slot refills as soon as its phase is done.
// Every sum keeps the order of attn::tile_update: a CTA of kConsumers
// threads gives the bits of the 128-thread walk.
//
// Sizing (the host's rule, kernels/decode_ring.py, which passes ns): a
// slot holds one tile's K or V rows (32 KB for a bf16 tile of 128 keys at d
// 128, 64 KB in float32, 16 KB in int8), up to kMaxSlots, in the shared
// memory the CTA's float state leaves; fewer than two slots, or rows whose
// bytes are not a multiple of 16, keep the device-memory walk.
// mbarrier waits trap after about 2^24 polls instead of hanging the card.
#pragma once

#include "attn_tc.cuh"
#include "attn_tile.cuh"

namespace ring {

constexpr int kConsumers = 256;            // threads that run phases A-C
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxSlots = 8;
constexpr int kStaticBytes = 1024;         // static shared memory a ring kernel may declare
constexpr int kConsumerBar = 1;            // named barrier of the consumers

__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers) : "memory");
}

// Bytes of one slot: a tile's K or V rows, rounded up to 128.
__host__ __device__ inline size_t slot_bytes(size_t elem, int d, int tile) {
  return ((size_t)tile * d * elem + 127) / 128 * 128;
}

// Whether `ns` slots fit beside `state` bytes of float state (ns 0: the
// device-memory walk, always taken).
__host__ __device__ inline bool fits(int ns, size_t elem, int d, int tile, size_t state) {
  if (ns == 0) return true;
  return ns >= 2 && ns <= kMaxSlots && (size_t)d * elem % 16 == 0 &&
         ns * slot_bytes(elem, d, tile) + state <= attn::kSmemLimit - kStaticBytes;
}

struct Ring {
  unsigned char* base;  // slot 0; slot i at base + i * slot
  uint32_t slot;
  int ns;
  uint64_t* full;       // (kMaxSlots) the slot's copy has landed
  uint64_t* empty;      // (kMaxSlots) the consumers are done with it

  __device__ unsigned char* at(int n) const { return base + (size_t)(n % ns) * slot; }
};

// Thread 0, before the CTA's first __syncthreads.
__device__ __forceinline__ void init(const Ring& r) {
  for (int i = 0; i < r.ns; ++i) {
    attn_tc::mbar_init(attn_tc::smem_u32(&r.full[i]), 1);
    attn_tc::mbar_init(attn_tc::smem_u32(&r.empty[i]), 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer: wait until copy n's slot is free (its copy n - ns released).
__device__ __forceinline__ void acquire(const Ring& r, int n) {
  const int use = n / r.ns;
  if (use > 0) attn_tc::mbar_wait(attn_tc::smem_u32(&r.empty[n % r.ns]), (use - 1) & 1);
}

// Producer, after acquire: copy n, `bytes` (a multiple of 16, maybe 0) from
// src into its slot. Anything the producer wrote to shared memory for this
// copy before the call is visible to the consumers once they see it land.
__device__ __forceinline__ void fill(const Ring& r, int n, const void* src, uint32_t bytes) {
  const uint32_t bar = attn_tc::smem_u32(&r.full[n % r.ns]);
  attn_tc::mbar_expect_tx(bar, bytes);
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(attn_tc::smem_u32(r.at(n))), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
          "r"(bar)
        : "memory");
}

// Consumers: wait for copy n; its slot.
__device__ __forceinline__ const unsigned char* wait(const Ring& r, int n) {
  attn_tc::mbar_wait(attn_tc::smem_u32(&r.full[n % r.ns]), (n / r.ns) & 1);
  return r.at(n);
}

// One consumer thread, once every consumer is done with copy n.
__device__ __forceinline__ void release(const Ring& r, int n) {
  attn_tc::mbar_arrive(attn_tc::smem_u32(&r.empty[n % r.ns]));
}

// The decode update of the GQ rows against one tile whose K rows are copy n
// and V rows copy n + 1 (vlen keys; int8 rows with their scales ks, vs), on
// the consumers: attn::tile_update's phases on the staged rows. Caller
// syncs the consumers before (q/acc ready); this syncs them after.
template <typename T, int GQ>
__device__ __forceinline__ void tile_update(const Ring& r, int n, int vlen, const attn::Smem& s,
                                            int d, int tile, float scale, float ks, float vs) {
  const T* kp = reinterpret_cast<const T*>(wait(r, n));
  attn::decode_scores<T, GQ, kConsumers>(kp, vlen, s, d, tile, scale, ks);
  sync_consumers();
  if (threadIdx.x == 0) release(r, n);
  attn::decode_softmax<GQ, kConsumers>(vlen, s, tile);
  sync_consumers();
  const T* vp = reinterpret_cast<const T*>(wait(r, n + 1));
  attn::decode_pv<T, GQ, kConsumers>(vp, vlen, s, d, tile, vs);
  sync_consumers();
  if (threadIdx.x == 0) release(r, n + 1);
}

}  // namespace ring
