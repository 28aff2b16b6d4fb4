// dense_segment_sum (K4): per-segment sums of pixel rows,
//   out[s, c] = sum of values[p, c] over the pixels p with ids[p] == s,
// for s in [0, S); pixels whose id lies outside [0, S) drop out.
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:
// dense_segment_sum_fwd (body _dense_segsum_kernel), which the region
// losses (gags_tpu/gad/losses.py) run for the per-region counts, sums and
// moments. The TPU kernel builds a one-hot (chunk, S) matrix per pixel
// chunk and multiplies it on the MXU, which caps it at ~2k segments; this
// kernel covers any segment count, so the port runs it at the library
// default of 4097 segments too.
//
// What bounds it on the H100: bytes (P * C floats and P ids read once,
// S * C sums written once) in principle; in practice the atomic additions,
// since neighbouring pixels mostly share a segment.
//
// Design (simple first): a histogram in shared memory. Each block takes a
// span of pixels and a slice of CS channels such that the S * CS float
// accumulators fit in the opt-in shared memory (at most 128 KiB here):
// 1025 segments x 31 channels, or 4097 segments x 7 channels. Consecutive
// threads take consecutive (pixel, channel) pairs, so a warp's
// shared-memory atomicAdds spread over CS addresses even where its pixels
// share a segment. The block then adds its non-zero accumulators to the
// zeroed output with global atomicAdds. The order of the additions varies
// from run to run at the float-rounding level. Where even one channel of
// S segments exceeds the budget (S > 32768), the blocks add straight into
// the output with global atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = 4096;
constexpr int kSmemBudget = 128 * 1024;

__global__ void __launch_bounds__(kThreads)
dense_segment_sum_kernel(const float* __restrict__ values,
                         const int* __restrict__ ids, float* __restrict__ out,
                         int num_pixels, int channels, int num_segments,
                         int slice) {
  extern __shared__ float acc[];  // (num_segments, slice) when slice > 0
  const int p0 = blockIdx.x * kPixelsPerBlock;
  const int np = min(kPixelsPerBlock, num_pixels - p0);
  const int cs = slice > 0 ? slice : channels;
  const int c0 = blockIdx.y * cs;
  const int cw = min(cs, channels - c0);
  const bool shared = slice > 0;
  if (shared) {
    for (int i = threadIdx.x; i < num_segments * cs; i += blockDim.x)
      acc[i] = 0.0f;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < np * cw; i += blockDim.x) {
    const int pl = i / cw;
    const int c = i - pl * cw;
    const int p = p0 + pl;
    const int s = ids[p];
    if (s < 0 || s >= num_segments) continue;
    const float v = values[static_cast<size_t>(p) * channels + c0 + c];
    if (shared)
      atomicAdd(&acc[s * cs + c], v);
    else
      atomicAdd(&out[static_cast<size_t>(s) * channels + c0 + c], v);
  }
  if (!shared) return;
  __syncthreads();
  for (int i = threadIdx.x; i < num_segments * cs; i += blockDim.x) {
    const int s = i / cs;
    const int c = i - s * cs;
    const float v = acc[i];
    if (c < cw && v != 0.0f)
      atomicAdd(&out[static_cast<size_t>(s) * channels + c0 + c], v);
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels per block for `num_segments` segments (0: global atomics).
int gags_dense_segment_sum_slice(int num_segments, int channels) {
  const int fit = kSmemBudget / (4 * num_segments);
  return fit < channels ? fit : channels;
}

// values (P, C) f32, ids (P,) i32, out (S, C) f32 ZEROED. Launches on
// `stream` and returns the first CUDA error of the set-up or the launch.
int gags_dense_segment_sum(const void* values, const void* ids, void* out,
                           int num_pixels, int channels, int num_segments,
                           void* stream) {
  if (num_pixels <= 0 || channels <= 0 || num_segments <= 0) return 0;
  const int slice = gags_dense_segment_sum_slice(num_segments, channels);
  const int cs = slice > 0 ? slice : channels;
  const size_t smem =
      slice > 0 ? static_cast<size_t>(num_segments) * slice * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_pixels + kPixelsPerBlock - 1) / kPixelsPerBlock,
                  (channels + cs - 1) / cs);
  dense_segment_sum_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(ids),
      static_cast<float*>(out), num_pixels, channels, num_segments, slice);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
