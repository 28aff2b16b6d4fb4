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
//
// K5's inference options (kernels.blend_forward):
//   fast_color_rows  the colour table is bf16 (the wrapper rounds it to
//                    nearest even, as astype(jnp.bfloat16)): the colour type
//                    is a template parameter, rows are staged as bf16 and
//                    accumulated in f32. Halves the colour bytes.
//   blend_bf16       weights and colours enter the colour multiply-add as
//                    bf16, as the TPU's MXU operands do (its colour table is
//                    bf16 too). Their product is exact in f32 and the sum is
//                    f32. Transmittance stays f32 here: tighter than the TPU's
//                    bf16 LN-unit scan, so its contract (image max error <=
//                    5e-2 and mean <= 5e-3 of the image's scale, alpha atol
//                    0.03) holds a fortiori.
//   exit_stats       per-tile early-exit counters (a nullable pointer, not a
//                    template parameter, so the build stays 16 instances):
//                    each pixel reports the chunk (of `chunk` instances,
//                    counted from the range's chunk-aligned base) that holds
//                    the splat where it stopped, or "never", and log2 of its
//                    naive T at that splat (of its final T when it never
//                    stopped); a warp max and one atomicMax per warp and tile
//                    reduce them across the tile's bands (the log as an
//                    order-preserving int, since the raw bits of negative
//                    floats order backwards). The wrapper turns the two ints
//                    per tile into the TPU kernel's (T, 8, 128) block.
//   block_exit       no switch here: this kernel already retires per pixel and
//                    per block (the __syncthreads_count exit below), so the
//                    flag is accepted and the output is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// log2 T as an int whose signed order is the float order (negative floats'
// raw bits order backwards); kernels.py undoes it
__device__ __forceinline__ int ordered_int(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

template <int C, typename Col>
__global__ void __launch_bounds__(kMaxThreads)
blend_forward_kernel(const float* __restrict__ geom,
                     const Col* __restrict__ colors,
                     const int* __restrict__ inst_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ bg, float* __restrict__ out,
                     int* __restrict__ stats, int tiles_x, int tile_h,
                     int tile_w, int bf16_weights, int chunk) {
  extern __shared__ float smem[];
  const int batch = blockDim.x;
  float* s_mx = smem;
  float* s_my = s_mx + batch;
  float* s_ca = s_my + batch;
  float* s_cb = s_ca + batch;
  float* s_cc = s_cb + batch;
  float* s_op = s_cc + batch;
  Col* s_col = reinterpret_cast<Col*>(s_op + batch);  // (batch, C)

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
  int stop = -1;        // range index of the splat that ended the pixel
  float t_stop = 1.0f;  // the naive T just after it

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
      const Col* cr = colors + static_cast<size_t>(g) * C;
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
          stop = b0 + k;
          t_stop = next_t;
          break;
        }
        float w = gags::blend_weight(T, alpha);
        if (bf16_weights) w = __bfloat162float(__float2bfloat16(w));
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * to_float(s_col[k * C + c]);
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

  if (stats != nullptr) {  // uniform over the block: every lane reaches here
    int chunk1 = 0, lt = INT_MIN;  // out-of-tile threads add nothing
    if (in_tile) {
      // the chunk after the stopping splat's, or "never" (INT_MAX)
      chunk1 = stop >= 0 ? (start % chunk + stop) / chunk + 1 : INT_MAX;
      lt = ordered_int(log2f(stop >= 0 ? t_stop : T));
    }
    chunk1 = __reduce_max_sync(0xffffffffu, chunk1);
    lt = __reduce_max_sync(0xffffffffu, lt);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(stats + 2 * tile, chunk1);
      atomicMax(stats + 2 * tile + 1, lt);
    }
  }
}

template <int C, typename Col>
int launch(const float* geom, const void* colors, const int* inst_gid,
           const int* tile_starts, const int* tile_counts, const float* bg,
           float* out, int* stats, int num_tiles, int tiles_x, int tile_h,
           int tile_w, int bf16_weights, int chunk, cudaStream_t stream) {
  const int npix = tile_h * tile_w;
  int threads = npix < kMaxThreads ? npix : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(num_tiles, (npix + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads) * (6 * sizeof(float) + C * sizeof(Col));
  blend_forward_kernel<C, Col><<<grid, threads, smem, stream>>>(
      geom, static_cast<const Col*>(colors), inst_gid, tile_starts, tile_counts, bg,
      out, stats, tiles_x, tile_h, tile_w, bf16_weights, chunk);
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

template <typename Col>
int dispatch(const void* geom, const void* colors, const void* inst_gid,
             const void* tile_starts, const void* tile_counts, const void* bg,
             void* out, void* stats, int num_tiles, int tiles_x, int tile_h,
             int tile_w, int channels, int bf16_weights, int chunk, void* stream) {
  auto g = static_cast<const float*>(geom);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto b = static_cast<const float*>(bg);
  auto o = static_cast<float*>(out);
  auto st = static_cast<int*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                          \
  case CH:                                                                     \
    return launch<CH, Col>(g, colors, id, ts, tc, b, o, st, num_tiles, tiles_x, \
                           tile_h, tile_w, bf16_weights, chunk, s);
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

// K5. geom (R, 8) f32, colors (R, C) f32 or, with bf16_colors, bf16,
// inst_gid (M,) i32, tile_starts and tile_counts (num_tiles,) i32, bg (C,)
// f32, out (num_tiles, P, C+1) f32; stats null or (num_tiles, 2) i32
// initialised to (0, INT_MIN), which receives per tile the largest
// stopping chunk + 1 (INT_MAX: some pixel never stopped) and the largest
// log2 T as an ordered int; chunk: the instances per chunk those count.
// bf16_weights rounds every blend weight to bf16 before the colour
// multiply-add. Launches on `stream` and returns cudaGetLastError() of the
// launch.
int gags_blend_forward(const void* geom, const void* colors,
                       const void* inst_gid, const void* tile_starts,
                       const void* tile_counts, const void* bg, void* out,
                       void* stats, int num_tiles, int tiles_x, int tile_h,
                       int tile_w, int channels, int bf16_colors,
                       int bf16_weights, int chunk, void* stream) {
  if (num_tiles <= 0) return 0;
  if (stats != nullptr && chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_colors) {
    return dispatch<__nv_bfloat16>(geom, colors, inst_gid, tile_starts, tile_counts, bg,
                                   out, stats, num_tiles, tiles_x, tile_h, tile_w,
                                   channels, bf16_weights, chunk, stream);
  }
  return dispatch<float>(geom, colors, inst_gid, tile_starts, tile_counts, bg, out,
                         stats, num_tiles, tiles_x, tile_h, tile_w, channels,
                         bf16_weights, chunk, stream);
}

// K1, over an aligned binning (chunk-aligned starts, tile_counts = the real
// instances of each range): f32 colours, no options.
int gags_blend_forward_aligned(const void* geom, const void* colors,
                               const void* inst_gid, const void* tile_starts,
                               const void* tile_counts, const void* bg,
                               void* out, int num_tiles, int tiles_x,
                               int tile_h, int tile_w, int channels,
                               void* stream) {
  if (num_tiles <= 0) return 0;
  return dispatch<float>(geom, colors, inst_gid, tile_starts, tile_counts, bg, out,
                         nullptr, num_tiles, tiles_x, tile_h, tile_w, channels, 0, 0,
                         stream);
}

}  // extern "C"
