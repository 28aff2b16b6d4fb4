// blend_backward_full (K8): the full vector-Jacobian product of the
// training blend, per instance slot: the colour gradient
// grad_col[j, c] = sum_p w[p, j] g[p, c] and the screen-space geometry
// gradient grad_geom[j] = [mx, my, ca, cb, cc, opac, 0, 0].
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:
// tile_blend_backward_full (body _backward_full_kernel). Same contract,
// except for the layout: the outputs are row-major (M, C) and (M, 8), one
// row per instance slot, which K3 (sorted_segment_sum.cu) reads directly.
// The alpha cotangent comes in already net of the background term
// (g_alpha - g . bg), as rasterizer._BlendFull passes it. For every splat
// i that pixel p blends (u_i = g[p] . colour_i, T_i the transmittance in
// front of it, T_fin the transmittance after the last splat p blends):
//
//   dL/dalpha_i = u_i T_i - S_i / (1 - alpha_i) + g_alpha T_fin / (1 - alpha_i),
//   S_i = sum of u_j w_j over the splats j blended after i,
//   dL/dsigma = -alpha_i dL/dalpha_i,  dL/dopac = dL/dalpha_i exp(-sigma).
//
// A splat clamped at alpha = 0.999 keeps its colour gradient and gets no
// geometry gradient; a floored splat (alpha < 1/255, or sigma < 0) and
// every splat behind the one that ends the pixel get nothing. The
// per-pair alpha and inclusion arithmetic is blend_common.cuh's, shared
// with K1 (blend_forward.cu), so both walks retrace exactly the splats the
// forward blended and no gradient flips at 1/255 or 1e-4.
//
// Two walks, the JAX package's scheme (a walk A then a walk B, no stored
// residuals): walk A gives each pixel Total = sum u_i w_i and T_fin;
// walk B recomputes the same weights and takes S_i = Total - (inclusive
// prefix of u w). Both walks accumulate u w with the same round-to-nearest
// operations in the same order, so the prefix at the last blended splat
// equals Total bit for bit and its S is exactly 0. (gsplat's back-to-front
// walk would recover T_i by dividing by 1 - alpha; this scheme never
// divides T.)
//
// What bounds it on the H100: operations. Each walked (pixel, instance)
// pair evaluates the blend_common arithmetic (~16 float ops and one exp)
// in each walk; each blended pair adds the C-term dot product u in each
// walk, ~30 ops of the chain rule and C + 6 values summed over the tile's
// pixels into the instance's row.
//
// Design (simple first), K2's layout: one thread per pixel in bands of at
// most 256 threads (four blocks per 32x32 tile), the pixel's cotangent
// row held in registers (C is a template parameter). Batches of instances
// (their geometry and colour rows) are staged in shared memory. In walk A
// every thread walks on its own and stops at its pixel's end. In walk B
// the warps walk a batch in lock step (a pixel that has stopped
// contributes zeros); a warp whose lanes all have w = 0 for an instance
// skips it; otherwise each of the C + 6 values is summed across the warp
// with __shfl_down_sync and lane 0 adds it to the batch's shared
// accumulator. After the batch each non-zero accumulator is added to its
// row with one float atomicAdd (the bands of a tile share rows), so the
// order of those additions varies from run to run at the rounding level.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGeomGrads = 6;  // mx, my, ca, cb, cc, opac
constexpr int kGeomRow = 8;    // output row: the 6 gradients, then 2 zeros
constexpr size_t kSmemLimit = 48 * 1024;  // no opt-in above the default
constexpr unsigned kFullMask = 0xffffffffu;

// u = g . colour, channel by channel with round-to-nearest operations, so
// the two walks compute it bit for bit alike
template <int C>
__device__ __forceinline__ float dot_rn(const float* g, const float* col) {
  float u = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) u = __fadd_rn(u, __fmul_rn(g[c], col[c]));
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

template <int C>
__device__ __forceinline__ void stage(const float* __restrict__ geom,
                                      const float* __restrict__ colors,
                                      const int* __restrict__ inst_gid,
                                      int first, int nb, float* s_geo,
                                      float* s_col, int batch) {
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    const int r = inst_gid[first + k];
    const float* gr = geom + static_cast<size_t>(r) * 8;
#pragma unroll
    for (int i = 0; i < kGeomGrads; ++i) s_geo[i * batch + k] = gr[i];
    const float* cr = colors + static_cast<size_t>(r) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) s_col[k * C + c] = cr[c];
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
blend_backward_full_kernel(const float* __restrict__ geom,
                           const float* __restrict__ colors,
                           const int* __restrict__ inst_gid,
                           const int* __restrict__ tile_starts,
                           const int* __restrict__ tile_counts,
                           const float* __restrict__ gout,
                           const float* __restrict__ galpha,
                           float* __restrict__ grad_col,
                           float* __restrict__ grad_geom, int tiles_x,
                           int tile_h, int tile_w, int batch) {
  constexpr int kAcc = C + kGeomGrads;  // accumulated values per instance
  extern __shared__ float smem[];
  float* s_geo = smem;                         // (6, batch): mx my ca cb cc op
  float* s_col = s_geo + kGeomGrads * batch;   // (batch, C)
  float* s_acc = s_col + batch * C;            // (batch, C + 6)
  const float* s_mx = s_geo;
  const float* s_my = s_geo + batch;
  const float* s_ca = s_geo + 2 * batch;
  const float* s_cb = s_geo + 3 * batch;
  const float* s_cc = s_geo + 4 * batch;
  const float* s_op = s_geo + 5 * batch;

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
  const size_t pix = static_cast<size_t>(tile) * npix + p;
#pragma unroll
  for (int c = 0; c < C; ++c) gp[c] = in_tile ? gout[pix * C + c] : 0.0f;
  const float ga = in_tile ? galpha[pix] : 0.0f;

  // ---- walk A: Total and T_fin of this pixel ----------------------------
  float T = 1.0f;
  float total = 0.0f;
  bool alive = in_tile;
  for (int b0 = 0; b0 < count; b0 += batch) {
    if (__syncthreads_count(alive) == 0) break;
    const int nb = min(batch, count - b0);
    stage<C>(geom, colors, inst_gid, start + b0, nb, s_geo, s_col, batch);
    __syncthreads();
    for (int k = 0; alive && k < nb; ++k) {
      const float alpha = gags::splat_alpha(px, py, s_mx[k], s_my[k], s_ca[k],
                                            s_cb[k], s_cc[k], s_op[k]);
      if (alpha == 0.0f) continue;
      const float next_t = gags::next_transmittance(T, alpha);
      if (next_t < gags::kTEps) {
        alive = false;
      } else {
        const float w = gags::blend_weight(T, alpha);
        total = __fadd_rn(total, __fmul_rn(dot_rn<C>(gp, &s_col[k * C]), w));
        T = next_t;
      }
    }
  }
  const float t_fin = T;
  const float ga_tfin = ga * t_fin;

  // ---- walk B: the gradients ---------------------------------------------
  T = 1.0f;
  float prefix = 0.0f;
  alive = in_tile;
  for (int b0 = 0; b0 < count; b0 += batch) {
    if (__syncthreads_count(alive) == 0) break;
    const int nb = min(batch, count - b0);
    stage<C>(geom, colors, inst_gid, start + b0, nb, s_geo, s_col, batch);
    for (int i = threadIdx.x; i < batch * kAcc; i += blockDim.x) s_acc[i] = 0.0f;
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      if (!__any_sync(kFullMask, alive)) break;  // uniform across the warp
      float w = 0.0f, dl_ds = 0.0f, dl_dop = 0.0f, dx = 0.0f, dy = 0.0f;
      if (alive) {
        float vis = 0.0f;
        const float alpha = gags::splat_alpha_parts(
            px, py, s_mx[k], s_my[k], s_ca[k], s_cb[k], s_cc[k], s_op[k], &dx,
            &dy, &vis);
        if (alpha != 0.0f) {
          const float next_t = gags::next_transmittance(T, alpha);
          if (next_t < gags::kTEps) {
            alive = false;
          } else {
            w = gags::blend_weight(T, alpha);
            const float u = dot_rn<C>(gp, &s_col[k * C]);
            prefix = __fadd_rn(prefix, __fmul_rn(u, w));
            const float inv = 1.0f / (1.0f - alpha);
            const float dl_da = u * T - (total - prefix) * inv + ga_tfin * inv;
            if (alpha < gags::kAlphaClamp) {
              dl_ds = -alpha * dl_da;
              dl_dop = dl_da * vis;
            }
            T = next_t;
          }
        }
      }
      if (!__any_sync(kFullMask, w != 0.0f)) continue;
      float* acc = &s_acc[k * kAcc];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = warp_sum(w * gp[c]);
        if (lane == 0) atomicAdd(&acc[c], v);
      }
      const float ca = s_ca[k], cb = s_cb[k], cc = s_cc[k];
      const float gv[kGeomGrads] = {
          dl_ds * -(ca * dx + cb * dy), dl_ds * -(cc * dy + cb * dx),
          dl_ds * (0.5f * dx * dx),     dl_ds * (dx * dy),
          dl_ds * (0.5f * dy * dy),     dl_dop};
#pragma unroll
      for (int i = 0; i < kGeomGrads; ++i) {
        const float v = warp_sum(gv[i]);
        if (lane == 0) atomicAdd(&acc[C + i], v);
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      const size_t j = static_cast<size_t>(start + b0 + k);
      const float* acc = &s_acc[k * kAcc];
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (acc[c] != 0.0f) atomicAdd(&grad_col[j * C + c], acc[c]);
#pragma unroll
      for (int i = 0; i < kGeomGrads; ++i)
        if (acc[C + i] != 0.0f) atomicAdd(&grad_geom[j * kGeomRow + i], acc[C + i]);
    }
  }
}

template <int C>
size_t smem_bytes(int batch) {
  return static_cast<size_t>(batch) * (kGeomGrads + C + C + kGeomGrads) * sizeof(float);
}

template <int C>
int launch(const float* geom, const float* colors, const int* inst_gid,
           const int* tile_starts, const int* tile_counts, const float* gout,
           const float* galpha, float* grad_col, float* grad_geom,
           int num_tiles, int tiles_x, int tile_h, int tile_w,
           cudaStream_t stream) {
  const int npix = tile_h * tile_w;
  int threads = npix < kMaxThreads ? npix : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  // instances staged per batch: one per thread, halved until the batch's
  // rows fit the default 48 KiB of shared memory (C = 32 takes 128)
  int batch = threads;
  while (batch > 32 && smem_bytes<C>(batch) > kSmemLimit) batch /= 2;
  const dim3 grid(num_tiles, (npix + threads - 1) / threads);
  blend_backward_full_kernel<C><<<grid, threads, smem_bytes<C>(batch), stream>>>(
      geom, colors, inst_gid, tile_starts, tile_counts, gout, galpha, grad_col,
      grad_geom, tiles_x, tile_h, tile_w, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channel counts compiled (those of K1 and K2); the wrapper zero-pads
// other counts up to one.
int gags_blend_backward_full_channels(int i) {
  static const int kChannels[] = {1, 2, 3, 4, 8, 16, 17, 32};
  return i < 8 ? kChannels[i] : 0;
}

// geom (R, 8) f32, colors (R, C) f32, inst_gid (M,) i32, tile_starts and
// tile_counts (num_tiles,) i32, gout (num_tiles, P, C) f32, galpha
// (num_tiles, P) f32 net of the background term; grad_col (M, C) and
// grad_geom (M, 8) f32 ZEROED. Launches on `stream` and returns
// cudaGetLastError() of the launch.
int gags_blend_backward_full(const void* geom, const void* colors,
                             const void* inst_gid, const void* tile_starts,
                             const void* tile_counts, const void* gout,
                             const void* galpha, void* grad_col,
                             void* grad_geom, int num_tiles, int tiles_x,
                             int tile_h, int tile_w, int channels,
                             void* stream) {
  if (num_tiles <= 0) return 0;
  auto g = static_cast<const float*>(geom);
  auto col = static_cast<const float*>(colors);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto go = static_cast<const float*>(gout);
  auto ga = static_cast<const float*>(galpha);
  auto gc = static_cast<float*>(grad_col);
  auto gg = static_cast<float*>(grad_geom);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                        \
  case CH:                                                                   \
    return launch<CH>(g, col, id, ts, tc, go, ga, gc, gg, num_tiles,        \
                      tiles_x, tile_h, tile_w, s);
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
