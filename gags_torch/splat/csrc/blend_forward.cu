// blend_forward: front-to-back alpha composite of each tile's depth-sorted
// instance range. Two entry points share one kernel body:
//   gags_blend_forward          K5, the inference blend over unaligned ranges;
//   gags_blend_forward_aligned  K1, the training blend over chunk-aligned
//                               ranges (zero-opacity dummies pad each range).
//
// Replaces the TPU kernels gags_tpu/splat/pallas_kernel.py:
// tile_blend_forward_fast (body _forward_fast_kernel; K5) and
// tile_blend_forward (body _forward_kernel; K1). Same contract: output
// (T, P, C+1) float32, C channels with the background blended against the
// final transmittance, then alpha = 1 - T_final. The per-pair arithmetic
// (sigma, alpha, the 1/255 floor, the 1e-4 stop, the weight) lives in
// blend_common.cuh, which blend_backward.cu (K2) shares, so the backward
// retraces exactly the splats this kernel blended. An aligned range is an
// unaligned range that happens to start on a chunk: K1 walks
// [start, start + count) of the real instances, and the dummies after them
// (rank n, the zero row) would blend as no-ops anyway.
//
// Inputs are the rank-permuted tables the rasterizer builds: geometry
// (N+1, 8) [mx, my, ca, cb, cc, opac, 0, 0] and colours (N+1, C), each
// with a zero sentinel row, plus inst_gid (rank per instance slot) and the
// per-tile ranges. The kernel gathers each instance's rows through
// inst_gid itself; the TPU path's pre-gathered lane-major arrays, u16
// halves, segment slack and head/tail lane masks are DMA artefacts that
// this kernel does not need.
//
// What bounds it on the H100: operations. Each (pixel, instance) pair
// costs ~12 float ops plus one exp and 2C multiply-adds for blended pairs,
// against ~(6 + C) * 4 bytes of gathered rows per instance shared by a
// whole tile, so the pair count times the per-pair work dominates.
//
// Design (simple first): one thread per pixel; a tile's pixels are split
// into bands of at most 256 threads (four blocks per 32x32 tile), which
// keeps C accumulators plus T in registers at any C <= 32 without spills
// (__launch_bounds__(256) lets each thread use up to 255 registers). Each
// batch of blockDim instances is staged cooperatively into shared memory
// (6 geometry floats + C colours each, read by all threads as broadcasts);
// each thread walks the batch sequentially. The block stops as soon as
// __syncthreads_count reports no live pixel. The channel count is a
// template parameter so the accumulators stay in registers.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
blend_forward_kernel(const float* __restrict__ geom,
                     const float* __restrict__ colors,
                     const int* __restrict__ inst_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ bg, float* __restrict__ out,
                     int tiles_x, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  const int batch = blockDim.x;
  float* s_mx = smem;
  float* s_my = s_mx + batch;
  float* s_ca = s_my + batch;
  float* s_cb = s_ca + batch;
  float* s_cc = s_cb + batch;
  float* s_op = s_cc + batch;
  float* s_col = s_op + batch;  // (batch, C)

  const int tile = blockIdx.x;
  const int npix = tile_h * tile_w;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool in_tile = p < npix;
  float px, py;
  gags::pixel_centre(tile, p, tiles_x, tile_h, tile_w, &px, &py);
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool alive = in_tile;

  for (int b0 = 0; b0 < count; b0 += batch) {
    if (__syncthreads_count(alive) == 0) break;
    const int j = b0 + threadIdx.x;
    if (j < count) {
      const int g = inst_gid[start + j];
      const float* gr = geom + static_cast<size_t>(g) * 8;
      s_mx[threadIdx.x] = gr[0];
      s_my[threadIdx.x] = gr[1];
      s_ca[threadIdx.x] = gr[2];
      s_cb[threadIdx.x] = gr[3];
      s_cc[threadIdx.x] = gr[4];
      s_op[threadIdx.x] = gr[5];
      const float* cr = colors + static_cast<size_t>(g) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) s_col[threadIdx.x * C + c] = cr[c];
    }
    __syncthreads();
    const int nb = min(batch, count - b0);
    if (alive) {
      for (int k = 0; k < nb; ++k) {
        const float alpha = gags::splat_alpha(px, py, s_mx[k], s_my[k],
                                              s_ca[k], s_cb[k], s_cc[k],
                                              s_op[k]);
        if (alpha == 0.0f) continue;
        const float next_t = gags::next_transmittance(T, alpha);
        if (next_t < gags::kTEps) {
          alive = false;
          break;
        }
        const float w = gags::blend_weight(T, alpha);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * s_col[k * C + c];
        T = next_t;
      }
    }
    __syncthreads();  // the next batch overwrites the staged rows
  }

  if (in_tile) {
    float* o = out + (static_cast<size_t>(tile) * npix + p) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c] + T * bg[c];
    o[C] = 1.0f - T;
  }
}

template <int C>
int launch(const float* geom, const float* colors, const int* inst_gid,
           const int* tile_starts, const int* tile_counts, const float* bg,
           float* out, int num_tiles, int tiles_x, int tile_h, int tile_w,
           cudaStream_t stream) {
  const int npix = tile_h * tile_w;
  int threads = npix < kMaxThreads ? npix : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(num_tiles, (npix + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads) * (6 + C) * sizeof(float);
  blend_forward_kernel<C><<<grid, threads, smem, stream>>>(
      geom, colors, inst_gid, tile_starts, tile_counts, bg, out, tiles_x,
      tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channel counts compiled; the wrapper zero-pads other counts up to one.
int gags_blend_forward_channels(int i) {
  static const int kChannels[] = {1, 2, 3, 4, 8, 16, 17, 32};
  return i < 8 ? kChannels[i] : 0;
}

}  // extern "C"

namespace {

int dispatch(const void* geom, const void* colors, const void* inst_gid,
             const void* tile_starts, const void* tile_counts, const void* bg,
             void* out, int num_tiles, int tiles_x, int tile_h, int tile_w,
             int channels, void* stream) {
  if (num_tiles <= 0) return 0;
  auto g = static_cast<const float*>(geom);
  auto cl = static_cast<const float*>(colors);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto b = static_cast<const float*>(bg);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                       \
  case CH:                                                                  \
    return launch<CH>(g, cl, id, ts, tc, b, o, num_tiles, tiles_x, tile_h, \
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

}  // namespace

extern "C" {

// K5. geom (R, 8) f32, colors (R, C) f32, inst_gid (M,) i32, tile_starts
// and tile_counts (num_tiles,) i32, bg (C,) f32, out (num_tiles, P, C+1)
// f32. Launches on `stream` and returns cudaGetLastError() of the launch.
int gags_blend_forward(const void* geom, const void* colors,
                       const void* inst_gid, const void* tile_starts,
                       const void* tile_counts, const void* bg, void* out,
                       int num_tiles, int tiles_x, int tile_h, int tile_w,
                       int channels, void* stream) {
  return dispatch(geom, colors, inst_gid, tile_starts, tile_counts, bg, out,
                  num_tiles, tiles_x, tile_h, tile_w, channels, stream);
}

// K1, the same arguments over an aligned binning (chunk-aligned starts,
// tile_counts = the real instances of each range).
int gags_blend_forward_aligned(const void* geom, const void* colors,
                               const void* inst_gid, const void* tile_starts,
                               const void* tile_counts, const void* bg,
                               void* out, int num_tiles, int tiles_x,
                               int tile_h, int tile_w, int channels,
                               void* stream) {
  return dispatch(geom, colors, inst_gid, tile_starts, tile_counts, bg, out,
                  num_tiles, tiles_x, tile_h, tile_w, channels, stream);
}

}  // extern "C"
