// sorted_segment_sum (K3): per-rank sums of the per-instance gradient rows
// over the rank-sorted ReductionLayout (gags_torch/splat/tiles.py).
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:
// sorted_segment_sum (body _segsum_kernel). Same contract:
//   out[b * chunk + r, c] = sum of rows[slot_to_pos[s], c] over the slots s
//   of the chunks with chunk_block == b and slot_rank[s] == r,
// where padding slots carry slot_rank = -1 (and slot_to_pos = M, the
// position past the last row). Within one rank block's run of chunks the
// layout lists its slots in ascending rank (a stable sort of the
// instances' ranks), padding last. The kernel gathers the rows through
// slot_to_pos itself: the TPU path's u16 bit-half gather and its
// SEGSUM_SUB grouping are artefacts of its DMA engine.
//
// What bounds it on the H100: bytes. Each instance row (C floats) is read
// once through a gather, and each rank's sum is written once; there are
// about C adds per row.
//
// Design (deterministic, simple first): one block per rank block of
// `chunk` ranks. The block finds its run of chunks by binary search over
// the non-decreasing chunk_block; then each warp takes ranks r, r + 8, ...,
// finds the rank's slots [lo, hi) by binary search over the run's sorted
// slot ranks (padding counts as +infinity), and its lanes sum the rank's
// rows channel by channel in slot order. No atomics: every output row is
// written by exactly one warp, so the result does not vary between runs,
// and rank blocks without slots write zeros.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// first index in [lo, hi) whose key >= v; keys non-decreasing
__device__ __forceinline__ int lower_bound_block(const int* a, int lo, int hi,
                                                 int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int rank_key(const int* slot_rank, int s) {
  const int r = slot_rank[s];
  return r < 0 ? INT_MAX : r;
}

__device__ __forceinline__ int lower_bound_rank(const int* slot_rank, int lo,
                                                int hi, int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (rank_key(slot_rank, mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const float* __restrict__ rows,
                          const int* __restrict__ slot_to_pos,
                          const int* __restrict__ slot_rank,
                          const int* __restrict__ chunk_block,
                          float* __restrict__ out, int num_chunks, int chunk,
                          int channels, int num_ranks) {
  const int b = blockIdx.x;
  const int c0 = lower_bound_block(chunk_block, 0, num_chunks, b);
  const int c1 = lower_bound_block(chunk_block, c0, num_chunks, b + 1);
  const int s0 = c0 * chunk;
  const int s1 = c1 * chunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < chunk; r += kWarps) {
    const int rank = b * chunk + r;
    if (rank >= num_ranks) break;
    const int lo = lower_bound_rank(slot_rank, s0, s1, r);
    const int hi = lower_bound_rank(slot_rank, lo, s1, r + 1);
    for (int c = lane; c < channels; c += 32) {
      float acc = 0.0f;
      for (int s = lo; s < hi; ++s)
        acc += rows[static_cast<size_t>(slot_to_pos[s]) * channels + c];
      out[static_cast<size_t>(rank) * channels + c] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows (M, C) f32, slot_to_pos and slot_rank (num_chunks * chunk,) i32,
// chunk_block (num_chunks,) i32 non-decreasing, out (num_ranks, C) f32
// (every row written). Launches on `stream`; returns cudaGetLastError().
int gags_sorted_segment_sum(const void* rows, const void* slot_to_pos,
                            const void* slot_rank, const void* chunk_block,
                            void* out, int num_chunks, int chunk, int channels,
                            int num_ranks, void* stream) {
  if (num_ranks <= 0) return 0;
  const int blocks = (num_ranks + chunk - 1) / chunk;
  sorted_segment_sum_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(slot_to_pos),
      static_cast<const int*>(slot_rank), static_cast<const int*>(chunk_block),
      static_cast<float*>(out), num_chunks, chunk, channels, num_ranks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
