// Stream-K phase 2 as a kernel for Hopper: K3.
//
// Replaces the Pallas TPU kernel of the reference:
//   K3  repro/kernels/lean_decode.py:813  _lean_merge_kernel
//       (driven by lean_merge_pallas :852)
//
// What it computes: for each segment, the pieces [start, start + count) of
// K1's (or K4's) per-piece partials (o, m, l), folded in piece order with
// the softmax re-scaling operator (paper section IV-A, with the -inf
// guards of core/merge.py), then o = acc / l and lse = m + log l. Pieces
// are contiguous per segment (a schedule invariant), so (start, count) is
// the schedule's host-side piece_ranges(), uploaded once per schedule: the
// kernel needs no host sync, where segment_merge reads its grid width back
// from the device.
//
// What bounds it on this card: bytes -- each partial is read once and each
// output written once, with about 6 flops per element. One CTA per segment
// walks its rows' elements, one thread per (row, column) element, reading
// the piece rows coalesced; the per-row max and sum are re-read by every
// thread of the row from L1. The reference's grid (segments x pieces)
// revisited the output block across the sequential piece axis; here the
// piece axis is a loop inside the CTA.
//
// Plain C interface (loaded with ctypes); the entry point returns the
// cudaError_t of its launch.

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;

__global__ void __launch_bounds__(kThreads)
    lean_merge_kernel(const float* __restrict__ o_p, const float* __restrict__ m_p,
                      const float* __restrict__ l_p, const int* __restrict__ piece_start,
                      const int* __restrict__ piece_count, float* __restrict__ o,
                      float* __restrict__ lse, int rows, int d) {
  const int seg = blockIdx.x;
  const int start = piece_start[seg], count = piece_count[seg];
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d;
    float acc = 0.f, m = kNegInf, l = 0.f;
    for (int p = start; p < start + count; ++p)
      attn::merge_piece(o_p[(size_t)p * rows * d + e], m_p[(size_t)p * rows + r],
                        l_p[(size_t)p * rows + r], acc, m, l);
    o[(size_t)seg * rows * d + e] = acc / l;
    if (e - r * d == 0) lse[(size_t)seg * rows + r] = m + logf(l);
  }
}

}  // namespace

extern "C" {

// o_p (P, rows, d), m_p / l_p (P, rows) float32; piece_start / piece_count
// (S,) int32; o (S, rows, d), lse (S, rows) float32.
int lean_merge_launch(const float* o_p, const float* m_p, const float* l_p,
                      const int* piece_start, const int* piece_count, float* o, float* lse,
                      int num_segments, int rows, int d, void* stream) {
  if (num_segments <= 0 || rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  lean_merge_kernel<<<num_segments, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o_p, m_p, l_p, piece_start, piece_count, o, lse, rows, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
