// blend_backward (K2): colour vector-Jacobian product of the training
// blend, per instance: grad[j, c] = sum_p w[p, j] * g[p, c].
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:
// tile_blend_backward (body _backward_kernel). Same contract: the blend
// weights are recomputed from the geometry (no residual of the forward is
// kept), the cotangent g is the (T, P, C) gradient of the tile image (the
// alpha cotangent does not enter: alpha has no colour dependence), and
// the output is row-major (M, C) with one row per instance slot. Rows
// that no range covers, dummies and instances behind a pixel's stop stay
// zero (the wrapper allocates the output zeroed). The per-pair arithmetic
// is blend_common.cuh's, shared with the forward (blend_forward.cu), so
// this kernel retraces exactly the splats the forward blended.
//
// What bounds it on the H100: operations. Each walked (pixel, instance)
// pair repeats the forward's ~12 float ops and one exp; each pair with a
// non-zero weight adds C products that must be summed over the tile's
// pixels into the instance's row.
//
// Design (simple first): the forward's layout, one thread per pixel in
// bands of at most 256 threads (four blocks per 32x32 tile), each pixel's
// cotangent row held in registers (C is a template parameter). Batches of
// blockDim instances are staged in shared memory; every warp walks a batch
// in lock step (a pixel that has stopped contributes w = 0). A warp whose
// lanes all have w = 0 for an instance skips it; otherwise the C products
// are summed across the warp with __shfl_down_sync and lane 0 adds them to
// the batch's (batch, C) accumulator in shared memory. After the batch,
// each non-zero accumulator is added to its row with one float atomicAdd:
// the bands of a tile share rows, so the order of those additions (and of
// the warps' shared-memory additions) varies from run to run at the
// float-rounding level. A warp leaves the batch once none of its pixels is
// alive, and the block stops once none of its pixels is.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
blend_backward_kernel(const float* __restrict__ geom,
                      const int* __restrict__ inst_gid,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_counts,
                      const float* __restrict__ gout,
                      float* __restrict__ grad, int tiles_x, int tile_h,
                      int tile_w) {
  extern __shared__ float smem[];
  const int batch = blockDim.x;
  float* s_mx = smem;
  float* s_my = s_mx + batch;
  float* s_ca = s_my + batch;
  float* s_cb = s_ca + batch;
  float* s_cc = s_cb + batch;
  float* s_op = s_cc + batch;
  float* s_acc = s_op + batch;  // (batch, C)

  const int tile = blockIdx.x;
  const int npix = tile_h * tile_w;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool in_tile = p < npix;
  const int lane = threadIdx.x & 31;
  float px, py;
  gags::pixel_centre(tile, p, tiles_x, tile_h, tile_w, &px, &py);
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  float gp[C];
  const float* grow = gout + (static_cast<size_t>(tile) * npix + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) gp[c] = in_tile ? grow[c] : 0.0f;
  float T = 1.0f;
  bool alive = in_tile;

  for (int b0 = 0; b0 < count; b0 += batch) {
    if (__syncthreads_count(alive) == 0) break;
    const int j = b0 + threadIdx.x;
    if (j < count) {
      const float* gr = geom + static_cast<size_t>(inst_gid[start + j]) * 8;
      s_mx[threadIdx.x] = gr[0];
      s_my[threadIdx.x] = gr[1];
      s_ca[threadIdx.x] = gr[2];
      s_cb[threadIdx.x] = gr[3];
      s_cc[threadIdx.x] = gr[4];
      s_op[threadIdx.x] = gr[5];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) s_acc[threadIdx.x * C + c] = 0.0f;
    __syncthreads();
    const int nb = min(batch, count - b0);
    for (int k = 0; k < nb; ++k) {
      if (!__any_sync(kFullMask, alive)) break;  // uniform across the warp
      float w = 0.0f;
      if (alive) {
        const float alpha = gags::splat_alpha(px, py, s_mx[k], s_my[k],
                                              s_ca[k], s_cb[k], s_cc[k],
                                              s_op[k]);
        if (alpha != 0.0f) {
          const float next_t = gags::next_transmittance(T, alpha);
          if (next_t < gags::kTEps) {
            alive = false;
          } else {
            w = gags::blend_weight(T, alpha);
            T = next_t;
          }
        }
      }
      if (!__any_sync(kFullMask, w != 0.0f)) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = w * gp[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(kFullMask, v, off);
        if (lane == 0) atomicAdd(&s_acc[k * C + c], v);
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      float* row = grad + static_cast<size_t>(start + b0 + threadIdx.x) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = s_acc[threadIdx.x * C + c];
        if (v != 0.0f) atomicAdd(&row[c], v);
      }
    }
  }
}

template <int C>
int launch(const float* geom, const int* inst_gid, const int* tile_starts,
           const int* tile_counts, const float* gout, float* grad,
           int num_tiles, int tiles_x, int tile_h, int tile_w,
           cudaStream_t stream) {
  const int npix = tile_h * tile_w;
  int threads = npix < kMaxThreads ? npix : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(num_tiles, (npix + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads) * (6 + C) * sizeof(float);
  blend_backward_kernel<C><<<grid, threads, smem, stream>>>(
      geom, inst_gid, tile_starts, tile_counts, gout, grad, tiles_x, tile_h,
      tile_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channel counts compiled; the wrapper zero-pads other counts up to one.
int gags_blend_backward_channels(int i) {
  static const int kChannels[] = {1, 2, 3, 4, 8, 16, 17, 32};
  return i < 8 ? kChannels[i] : 0;
}

// geom (R, 8) f32, inst_gid (M,) i32, tile_starts and tile_counts
// (num_tiles,) i32, gout (num_tiles, P, C) f32, grad (M, C) f32 ZEROED.
// Launches on `stream` and returns cudaGetLastError() of the launch.
int gags_blend_backward(const void* geom, const void* inst_gid,
                        const void* tile_starts, const void* tile_counts,
                        const void* gout, void* grad, int num_tiles,
                        int tiles_x, int tile_h, int tile_w, int channels,
                        void* stream) {
  if (num_tiles <= 0) return 0;
  auto g = static_cast<const float*>(geom);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto go = static_cast<const float*>(gout);
  auto gr = static_cast<float*>(grad);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                       \
  case CH:                                                                  \
    return launch<CH>(g, id, ts, tc, go, gr, num_tiles, tiles_x, tile_h,   \
                      tile_w, s);
  switch (channels) {
    GAGS_CASE(1)
    GAGS_CASE(2)
    GAGS_CASE(3)
    GAGS_CASE(4)
    GAGS_CASE(8)
    GAGS_CASE(16)
    GAGS_CASE(17)
    GAGS_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GAGS_CASE
}

}  // extern "C"
