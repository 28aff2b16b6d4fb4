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
// S * C sums written once). The first design built a histogram of S x 7
// channels in shared memory per block of 4096 pixels: at S = 4097 two
// thirds of its shared-memory traffic went to zeroing and flushing
// accumulators, every block read 7 of a row's 33 columns, and it ran
// slower than one index_add_ at C = 33 (PERF.md section 6 has both
// designs' times, timed in turns on one card).
//
// Design: the ids are SAM masks, piecewise constant along image rows, so
// neighbouring pixels mostly share a segment. Each thread takes one
// channel of a strip of consecutive pixels, loads the strip's ids and
// values into registers (all loads in flight at once; consecutive threads
// take consecutive channels of the same pixel, so a warp's loads are
// contiguous), adds while the id holds and sends each run's sum to the
// output with one atomicAdd (compiled to red.global.add.f32; the output,
// S x C floats, stays in L2). Atomics scale with runs x C, not with
// pixels x C, and nothing scales with S: no shared memory, no zeroing, any
// segment count. Strips are 32 pixels where that gives the card enough
// threads (C = 33 at 640x360: 237,600), else 8 (C = 2: 57,600). The order
// of the additions varies from run to run at the float-rounding level.
// Device time per call on the GAD path (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W; the output's zeroing included): S = 4097, C = 33,
// 0.0155 ms against a 0.0095 ms bytes bound; C = 2, 0.0101 ms against
// 0.0008 ms: the fixed cost of two small kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kFill = 2LL * 132 * kThreads;  // two blocks per SM

template <int kStrip>
__global__ void __launch_bounds__(kThreads)
dense_segment_sum_kernel(const float* __restrict__ values,
                         const int* __restrict__ ids, float* __restrict__ out,
                         int num_pixels, int channels, int num_segments,
                         long long items) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= items) return;
  const int strip = static_cast<int>(item / channels);
  const int c = static_cast<int>(item - static_cast<long long>(strip) * channels);
  const int p0 = strip * kStrip;
  const int np = min(kStrip, num_pixels - p0);
  int id[kStrip];
  float v[kStrip];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if (i < np) {
      id[i] = ids[p0 + i];
      v[i] = values[static_cast<size_t>(p0 + i) * channels + c];
    }
  }
  int cur = id[0];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if (i < np) {
      if (id[i] != cur) {
        if (cur >= 0 && cur < num_segments)
          atomicAdd(&out[static_cast<size_t>(cur) * channels + c], acc);
        cur = id[i];
        acc = 0.0f;
      }
      acc += v[i];
    }
  }
  if (cur >= 0 && cur < num_segments)
    atomicAdd(&out[static_cast<size_t>(cur) * channels + c], acc);
}

template <int kStrip>
int launch(const void* values, const void* ids, void* out, int num_pixels,
           int channels, int num_segments, cudaStream_t stream) {
  const long long items = (num_pixels + kStrip - 1LL) / kStrip * channels;
  const long long blocks = (items + kThreads - 1) / kThreads;
  dense_segment_sum_kernel<kStrip><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(values), static_cast<const int*>(ids),
      static_cast<float*>(out), num_pixels, channels, num_segments, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values (P, C) f32, ids (P,) i32, out (S, C) f32 ZEROED. Launches on
// `stream` and returns the first CUDA error of the launch.
int gags_dense_segment_sum(const void* values, const void* ids, void* out,
                           int num_pixels, int channels, int num_segments,
                           void* stream) {
  if (num_pixels <= 0 || channels <= 0 || num_segments <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if ((num_pixels + 31LL) / 32 * channels >= kFill)
    return launch<32>(values, ids, out, num_pixels, channels, num_segments, s);
  return launch<8>(values, ids, out, num_pixels, channels, num_segments, s);
}

}  // extern "C"
