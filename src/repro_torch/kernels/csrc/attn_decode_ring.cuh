// The decode tile walk on a ring of shared-memory copies: K1 and K2
// (lean_decode.cu), K6 (flash_decode.cu) and K5 (lean_cascade.cu).
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
// n % ns. The stream-K walks (K1, K2, K5) hand each column's descriptor to
// the consumers beside its K copy (produce, Col). The consumers wait on
// `full`, run the three phases of the decode update on the staged rows
// (tile_update below) and release the K slot after phase A and the V slot
// after phase C, by one arrival on the slot's `empty` mbarrier, which the
// producer waits on before it fills the slot again. So up to ns copies --
// ns / 2 tiles -- are in flight while the consumers compute, and a slot
// refills as soon as its phase is done.
//
// The update is attn::tile_update's arithmetic, laid out for the staged
// rows: each lane keeps its d-stride slice of the query rows in registers
// (QSlice), phase A reduces a warp's KB x GQ partial dots in one
// transpose-reduce instead of one warp_sum each, and phase C reads four
// probabilities a float4 and two adjacent V columns a load, for two rows a
// thread at gq 4. Every sum keeps its terms and their order -- each dot's
// lane shares over d in lane-stride order and the same tree of xor-shuffle
// additions, each output column's PV over the keys in order by one thread
// -- so the bits are the walk's.
//
// Sizing (the host's rule, kernels/decode_ring.py, which passes ns): a
// slot holds one tile's K or V rows (32 KB for a bf16 tile of 128 keys at d
// 128, 64 KB in float32, 16 KB in int8 or e4m3), up to kMaxSlots, in the shared
// memory the CTA's float state leaves; fewer than two slots, or rows whose
// bytes are not a multiple of 16, keep the device-memory walk.
// mbarrier waits trap after about 2^24 polls instead of hanging the card.
#pragma once

#include <type_traits>

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

// Barriers of a fix-up's threads, passed to code that runs on the whole CTA
// of a device-memory walk or on a ring's consumers.
struct CtaSync {
  __device__ void operator()() const { __syncthreads(); }
};
struct ConsumerSync {
  __device__ void operator()() const { sync_consumers(); }
};

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

// ------------------------------------------------------- stream-K columns
// A descriptor column as the producer hands it to the consumers; seg < 0
// ends the walk.
struct Col {
  int seg, piece, vlen;
  int flags;  // kFirst | kLast
  float ks, vs;
};
constexpr int kFirst = 1, kLast = 2;

// The producer's lane on a stream-K walk of `steps` columns:
// column_at(t, c, row) fills c.seg, c.piece, c.flags and c.vlen of step t
// and its pool row, or returns false for a padding column. Each valid
// column's K and V rows are copied into the ring (0 bytes where no key is
// visible), its Col -- with the row's scales for int8 rows -- beside the K
// copy; then the end.
template <typename KV, typename ColumnAt>
__device__ void produce(int steps, ColumnAt column_at, const void* k_rows, const void* v_rows,
                        const float* k_scales, const float* v_scales, int d, int tile,
                        const Ring& r, Col* cols) {
  const KV* k = static_cast<const KV*>(k_rows);
  const KV* v = static_cast<const KV*>(v_rows);
  const size_t row_elems = (size_t)tile * d;
  int n = 0;
  for (int t = 0; t < steps; ++t) {
    Col c;
    size_t row;
    if (!column_at(t, c, row)) continue;
    c.ks = 1.f;
    c.vs = 1.f;
    if constexpr (attn::is_int8<KV>) {
      c.ks = k_scales[row];
      c.vs = v_scales[row];
    }
    const uint32_t bytes = (uint32_t)(c.vlen * d * sizeof(KV));
    acquire(r, n);
    cols[n % r.ns] = c;
    fill(r, n, k + row * row_elems, bytes);
    acquire(r, n + 1);
    fill(r, n + 1, v + row * row_elems, bytes);
    n += 2;
  }
  acquire(r, n);
  cols[n % r.ns].seg = -1;
  fill(r, n, nullptr, 0);
}

// ------------------------------------------------------------- the probe
// Built with -DDECODE_RING_CLOCKS (chip_smoke.py --decode-ring-clocks) a
// ring kernel stamps, on the first CTA's first consumer thread, clock64 at
// the edges of each tile's phases (g_tile_clocks: before the K wait, K
// landed, phase A done, its sync, phase B and its sync, V landed, phase C
// done, its sync), and on every CTA the global nanosecond timer at the
// consumers' start, when the first K copy landed, and at the end of the
// walk (g_cta_times), read back through decode_ring_clocks. Without the
// macro the stamps compile to nothing.
#ifdef DECODE_RING_CLOCKS
constexpr int kClockTiles = 64, kClockCtas = 4096;
__device__ long long g_tile_clocks[kClockTiles][8];
__device__ unsigned long long g_cta_times[kClockCtas][3];

__device__ __forceinline__ int cta_index() { return blockIdx.x + gridDim.x * blockIdx.y; }

__device__ __forceinline__ void tile_stamp(int n, int k) {
  if (threadIdx.x == 0 && cta_index() == 0 && n / 2 < kClockTiles)
    g_tile_clocks[n / 2][k] = clock64();
}

__device__ __forceinline__ void cta_stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0 && cta_index() < kClockCtas) g_cta_times[cta_index()][k] = t;
}
#else
__device__ __forceinline__ void tile_stamp(int, int) {}
__device__ __forceinline__ void cta_stamp(int) {}
#endif

// ------------------------------------------------------------- the update
// Each lane's d-stride slice of QR query rows in registers: v[r][i] =
// q[r][lane + 32 i] for the first kChunks * 32 columns (all of d 128),
// where the rows fit in registers beside phase A's dots (QR <= 8); phase A
// reads the columns past them, and every column of the larger row buckets,
// from s.q.
template <int QR>
struct QSlice {
  static constexpr int kChunks = QR <= 8 ? 4 : 0;
  float v[QR][kChunks > 0 ? kChunks : 1];

  // Once the consumers have stored the rows in s.q and synced.
  __device__ __forceinline__ void load(const attn::Smem& s, int d) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < QR; ++r)
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = lane + 32 * i;
        v[r][i] = c < d ? s.q[r * d + c] : 0.f;
      }
  }
};

// The xor-shuffle levels O, O/2, ..., 1 of attn::warp_sum over N values at
// once (x[0, N)). While a lane holds more than one value, a level halves
// them: the lane keeps the lower half (the upper half if its bit O is set),
// sends the other half to its partner and adds the partner's copy of the
// half it kept -- own + partner's, warp_sum's sum at that level -- and
// `base` counts where its half starts. Levels left over once a lane holds
// one value add it across lanes as warp_sum does. At the end x[i] is the
// full sum of value base + i.
template <int N, int O, int V>
__device__ __forceinline__ void reduce_scatter(float (&x)[V], int lane, int& base) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float give = up ? x[i] : x[i + H];
        const float keep = up ? x[i + H] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
      }
      if (up) base += H;
      reduce_scatter<H, O / 2>(x, lane, base);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
      reduce_scatter<1, O / 2>(x, lane, base);
    }
  }
}

// Phase A: the scores of the GQ rows against the staged K rows. One warp
// per key, KB keys a warp at a time -- 32 dots a warp (64 past 8 rows),
// enough independent work to hide the loads' and shuffles' latency with 8
// warps an SM; lanes stride over d (q from the slice, K rows read
// coalesced); the warp's KB x GQ dots then leave reduce_scatter spread
// over its lanes, and the lanes holding one each write it times the
// scale.
template <typename T, int GQ, int QR>
__device__ __forceinline__ void scores(const T* __restrict__ kp, int vlen, const attn::Smem& s,
                                       const QSlice<QR>& q, int d, int tile, float scale,
                                       float ks) {
  constexpr int NW = kConsumers / 32;
  constexpr int KB = GQ <= 8 ? 32 / GQ : GQ <= 64 ? 64 / GQ : 1;
  constexpr int V = KB * GQ;                   // dots a warp holds, index u * GQ + r
  constexpr int NQ = QSlice<QR>::kChunks;
  constexpr int PER_LANE = V >= 32 ? V / 32 : 1;
  constexpr int DUP = V >= 32 ? 1 : 32 / V;    // lanes that end with the same dot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = warp; j0 < vlen; j0 += KB * NW) {
    int krow[KB];  // offsets of the KB rows (a key past vlen reads row j0)
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int j = j0 + u * NW;
      krow[u] = (j < vlen ? j : j0) * d;
    }
    float part[V];
#pragma unroll
    for (int i = 0; i < V; ++i) part[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        float kv[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) kv[u] = attn::dequant(kp[krow[u] + c], ks);
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int r = 0; r < GQ; ++r) part[u * GQ + r] = fmaf(q.v[r][i], kv[u], part[u * GQ + r]);
      }
    }
    for (int c = lane + 32 * NQ; c < d; c += 32) {
      float kv[KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) kv[u] = attn::dequant(kp[krow[u] + c], ks);
#pragma unroll
      for (int u = 0; u < KB; ++u)
#pragma unroll
        for (int r = 0; r < GQ; ++r)
          part[u * GQ + r] = fmaf(s.q[r * d + c], kv[u], part[u * GQ + r]);
    }
    int base = 0;
    reduce_scatter<V, 16>(part, lane, base);
    if (lane % DUP == 0) {
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int idx = base + i, r = idx % GQ, j = j0 + idx / GQ * NW;
        if (j < vlen) s.p[r * tile + j] = part[i] * scale;
      }
    }
  }
}

// W adjacent values of a staged V row in one load, as float32 (int8 times
// the row's scale vs).
template <typename T, int W>
__device__ __forceinline__ void load_v(const T* src, float vs, float (&out)[W]) {
  constexpr int B = (int)sizeof(T) * W;
  using Raw = typename std::conditional<
      B == 8, uint2,
      typename std::conditional<B == 4, uint32_t,
                                typename std::conditional<B == 2, uint16_t, uint8_t>::type>::type>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(src);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = attn::dequant(x[w], vs);
}

// Four probabilities of a row, p[0..3]: one float4 where the row stride
// (the tile) keeps them 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ float4 load_p4(const float* p) {
  if constexpr (VEC)
    return *reinterpret_cast<const float4*>(p);
  else
    return make_float4(p[0], p[1], p[2], p[3]);
}

// Phase C: acc = alpha * acc + p @ v. A thread owns W = 2 adjacent output
// columns of RG rows and sums each column's PV over the keys in order, KC
// keys a step: KC V loads in flight, then KC / 4 float4 of p per row. A V row
// is read GQ / RG times in all, so RG trades the shared-memory traffic of
// the V reads (one pass per row group) against the FMA chains a thread
// runs: at d 128, 128 threads for up to 4 rows (RG = GQ / 2), 256 beyond.
template <typename T, int GQ, bool VEC>
__device__ __forceinline__ void pv(const T* __restrict__ vp, int vlen, const attn::Smem& s,
                                   int d, int tile, float vs) {
  constexpr int W = 2;
  constexpr int RG = GQ <= 4 ? (GQ >= 2 ? GQ / 2 : 1) : GQ / 4;
  constexpr int KC = 8;
  const int per_row = d / W, items = per_row * (GQ / RG);
  for (int e = threadIdx.x; e < items; e += kConsumers) {
    const int c = e % per_row * W, r0 = e / per_row * RG;
    const float* pr = s.p + r0 * tile;
    const T* vc = vp + c;
    float acc[RG][W];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[rr][w] = 0.f;
    int j = 0;
    for (; j + KC <= vlen; j += KC) {
      float v[KC][W];
#pragma unroll
      for (int u = 0; u < KC; ++u) load_v<T, W>(vc + (size_t)(j + u) * d, vs, v[u]);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        float p[KC];
#pragma unroll
        for (int u = 0; u < KC; u += 4) {
          const float4 a = load_p4<VEC>(pr + rr * tile + j + u);
          p[u] = a.x;
          p[u + 1] = a.y;
          p[u + 2] = a.z;
          p[u + 3] = a.w;
        }
#pragma unroll
        for (int u = 0; u < KC; ++u)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[rr][w] = fmaf(p[u], v[u][w], acc[rr][w]);
      }
    }
    for (; j < vlen; ++j) {
      float v[W];
      load_v<T, W>(vc + (size_t)j * d, vs, v);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[rr][w] = fmaf(pr[rr * tile + j], v[w], acc[rr][w]);
    }
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      const float a = s.alpha[r0 + rr];
      float* dst = s.acc + (r0 + rr) * d + c;
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = a * dst[w] + acc[rr][w];
    }
  }
}

// The decode update of the GQ rows against one tile whose K rows are copy n
// and V rows copy n + 1 (vlen keys; int8 rows with their scales ks, vs), on
// the consumers, with the rows' query slice q (QR >= GQ rows). Caller syncs
// the consumers before (q/acc ready); this syncs them after.
template <typename T, int GQ, int QR>
__device__ __forceinline__ void tile_update(const Ring& r, int n, int vlen, const attn::Smem& s,
                                            const QSlice<QR>& q, int d, int tile, float scale,
                                            float ks, float vs) {
  tile_stamp(n, 0);
  const T* kp = reinterpret_cast<const T*>(wait(r, n));
  tile_stamp(n, 1);
  if (n == 0) cta_stamp(1);
  scores<T, GQ, QR>(kp, vlen, s, q, d, tile, scale, ks);
  tile_stamp(n, 2);
  sync_consumers();
  tile_stamp(n, 3);
  if (threadIdx.x == 0) release(r, n);
  attn::decode_softmax<GQ, kConsumers>(vlen, s, tile);
  sync_consumers();
  tile_stamp(n, 4);
  const T* vp = reinterpret_cast<const T*>(wait(r, n + 1));
  tile_stamp(n, 5);
  if (tile % 4 == 0)
    pv<T, GQ, true>(vp, vlen, s, d, tile, vs);
  else
    pv<T, GQ, false>(vp, vlen, s, d, tile, vs);
  tile_stamp(n, 6);
  sync_consumers();
  tile_stamp(n, 7);
  if (threadIdx.x == 0) release(r, n + 1);
}

}  // namespace ring

#ifdef DECODE_RING_CLOCKS
// The probe's stamps copied to host buffers (kClockTiles x 8 and
// kClockCtas x 3 values), then zeroed on the card.
extern "C" int decode_ring_clocks(long long* tiles, unsigned long long* ctas) {
  static long long zero[ring::kClockCtas * 3];
  cudaError_t err = cudaMemcpyFromSymbol(tiles, ring::g_tile_clocks, sizeof(ring::g_tile_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(ctas, ring::g_cta_times, sizeof(ring::g_cta_times));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(ring::g_tile_clocks, zero, sizeof(ring::g_tile_clocks));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ring::g_cta_times, zero, sizeof(zero));
  return (int)err;
}
#endif
