// expand_gid: owning depth rank of every instance slot.
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:expand_gid
// (body _expand_gid_kernel), which recovers, for the ragged->dense instance
// expansion of the unaligned binning, the rank that owns each slot:
//
//     gid[i] = clip(#{j < n : offsets[j] <= i} - 1, 0, n - 1),  i < num_slots
//
// where `offsets` is the monotone exclusive cumsum of per-rank instance
// counts in depth-rank order.
//
// What bounds it on the H100: bytes. Each slot writes one int32 and reads
// ~log2(n) int32 of `offsets` in a binary search; the 1 MB `offsets` array
// of a 250k-Gaussian scene stays resident in the 50 MB L2, so device memory
// sees the output stream (4 B per slot) and one read of `offsets`.
//
// Design: one thread per slot, a branch-light upper-bound binary search
// over `offsets` in global memory (L2-resident, read through the read-only
// path). Neighbouring threads search for neighbouring values, so their
// probes hit the same cache lines. The TPU kernel's scalar-prefetched
// owner windows, (8, n_pad) table padding and n < 2^24 guard exist for
// Mosaic and are not needed here: this kernel serves every unaligned
// binning.

#include <cuda_runtime.h>

namespace {

__global__ void expand_gid_kernel(const int* __restrict__ offsets, int n,
                                  int* __restrict__ gid, int num_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_slots) return;
  // upper bound: first j with offsets[j] > i
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int g = lo - 1;
  g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
  gid[i] = g;
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// offsets: (n,) int32 on the device; gid: (num_slots,) int32 output.
// Launches on `stream` and returns cudaGetLastError() of the launch.
int gags_expand_gid(const void* offsets, int n, void* gid, int num_slots,
                    void* stream) {
  if (num_slots <= 0) return 0;
  const int threads = 256;
  const int blocks = (num_slots + threads - 1) / threads;
  expand_gid_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), n, static_cast<int*>(gid), num_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
