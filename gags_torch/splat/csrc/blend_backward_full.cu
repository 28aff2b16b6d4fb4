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
// Design (tile_reduce.cuh's layout): a tile is a thread-block cluster of
// bands of 256 threads; each thread owns PPT pixels (2 at C <= 4, the RGB
// trainer's C = 3; else 1) with their cotangent rows in registers (C is a
// template parameter), each warp a compact block of 32 PPT pixels.
// Batches of instances (geometry and colour rows) are gathered with
// cp.async, batch b + 1 while batch b is walked; each pair is tested
// first for the exact far-pair case (blend_common.cuh's surely_floored:
// no exp). In walk A every thread walks on its own and stops at its
// pixels' end; a band stops once none of its pixels is alive. In walk B
// the cluster walks as many batches as its longest band did in walk A,
// each warp in lock step (a pixel that has stopped contributes zeros).
// Per instance a thread first sums its own pixels' C + 6 values in
// registers; a warp in which no pixel blends the instance writes zeros;
// otherwise the warp reduces the C colour values and the 6 geometry
// values each by a transpose-reduce (C = 3: 3 + 9 shuffles where a
// shuffle tree per value took 45) into its row of the band's partials.
// After a cluster barrier the tile sums every (instance, value) over its
// warps in a fixed order and stores it: one writer per output row, no
// atomics, bit-identical across launches. Rows outside every range and
// behind every pixel's stop keep the zeros the wrapper allocates. The
// tiles start in order of decreasing instance count.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "tile_reduce.cuh"

namespace {

constexpr int kGeomGrads = 6;  // mx, my, ca, cb, cc, opac
constexpr int kGeomRow = 8;    // output row: the 6 gradients, then 2 zeros
constexpr int kMaxPairedChannels = 4;  // the widest C compiled at two pixels a thread

// u = g . colour, channel by channel with round-to-nearest operations, so
// the two walks compute it bit for bit alike
template <int C>
__device__ __forceinline__ float dot_rn(const float* g, const float* col) {
  float u = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) u = __fadd_rn(u, __fmul_rn(g[c], col[c]));
  return u;
}

// shared memory of a band: the double-buffered rows, the partials and
// the band's walk-A batch count
template <int C>
size_t smem_bytes(int warps) {
  constexpr int kBatch = gags::batch_for(C + kGeomGrads);
  return (static_cast<size_t>(2 * kBatch) * (8 + C) +
          static_cast<size_t>(kBatch) * warps * (C + kGeomGrads)) * sizeof(float) + 16;
}

template <int C, int PPT>
__global__ void __launch_bounds__(gags::kBandThreads)
blend_backward_full_kernel(const float* __restrict__ geom,
                           const float* __restrict__ colors,
                           const int* __restrict__ inst_gid,
                           const int* __restrict__ tile_starts,
                           const int* __restrict__ tile_counts,
                           const int* __restrict__ tile_order,
                           const float* __restrict__ gout,
                           const float* __restrict__ galpha,
                           float* __restrict__ grad_col,
                           float* __restrict__ grad_geom, int tiles_x,
                           int tile_h, int tile_w, int bands) {
  constexpr int V = C + kGeomGrads;  // summed values per instance
  constexpr int kBatch = gags::batch_for(V);
  gags::cg::cluster_group cluster = gags::cg::this_cluster();
  const int band = static_cast<int>(cluster.block_rank());
  const int tile = tile_order[blockIdx.x / bands];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float4 smem4[];
  float* s_geo = reinterpret_cast<float*>(smem4);  // [2][kBatch][8]
  float* s_col = s_geo + 2 * kBatch * 8;            // [2][kBatch][C]
  float* s_part = s_col + 2 * kBatch * C;           // [kBatch][warps][V]
  int* s_batches = reinterpret_cast<int*>(s_part + kBatch * warps * V);

  const int npix = tile_h * tile_w;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int batches = (count + kBatch - 1) / kBatch;

  float px[PPT], py[PPT], gp[PPT][C], ga[PPT];
  bool in_tile[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = gags::tile_pixel<PPT>(band * warps + warp, i, lane, tile_w, tile_h);
    in_tile[i] = p < npix;
    gags::pixel_centre(tile, p, tiles_x, tile_h, tile_w, &px[i], &py[i]);
    const size_t pix = static_cast<size_t>(tile) * npix + p;
#pragma unroll
    for (int c = 0; c < C; ++c) gp[i][c] = in_tile[i] ? gout[pix * C + c] : 0.0f;
    ga[i] = in_tile[i] ? galpha[pix] : 0.0f;
  }

  // ---- walk A: Total and T_fin of each pixel ----------------------------
  float T[PPT], total[PPT];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    total[i] = 0.0f;
    alive[i] = in_tile[i];
  }
  int walked = batches;  // batches this band needs
  if (batches > 0)
    gags::stage_rows<C>(geom, colors, inst_gid, start, min(kBatch, count), s_geo, s_col);
  for (int b = 0; b < batches; ++b) {
    gags::cp_async_wait_all();
    bool any = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // batch b has landed, and every thread is done with the other buffer
    if (!__syncthreads_or(any)) {
      walked = b;
      break;
    }
    if (b + 1 < batches) {
      const int nxt = (b + 1) * kBatch;
      gags::stage_rows<C>(geom, colors, inst_gid, start + nxt, min(kBatch, count - nxt),
                          s_geo + ((b + 1) & 1) * kBatch * 8, s_col + ((b + 1) & 1) * kBatch * C);
    }
    const float* sg = s_geo + (b & 1) * kBatch * 8;
    const float* sc = s_col + (b & 1) * kBatch * C;
    const int nb = min(kBatch, count - b * kBatch);
    for (int k = 0; any && k < nb; ++k) {
      const float4 g0 = reinterpret_cast<const float4*>(sg)[2 * k];
      const float2 g1 = reinterpret_cast<const float2*>(sg)[4 * k + 2];
      any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        float dx, dy, vis;
        const float sigma =
            gags::splat_sigma(px[i], py[i], g0.x, g0.y, g0.z, g0.w, g1.x, &dx, &dy);
        const float alpha =
            gags::surely_floored(sigma, g1.y) ? 0.0f : gags::alpha_of_sigma(sigma, g1.y, &vis);
        if (alpha != 0.0f) {
          const float next_t = gags::next_transmittance(T[i], alpha);
          if (next_t < gags::kTEps) {
            alive[i] = false;
          } else {
            const float w = gags::blend_weight(T[i], alpha);
            total[i] = __fadd_rn(total[i], __fmul_rn(dot_rn<C>(gp[i], &sc[k * C]), w));
            T[i] = next_t;
          }
        }
        any |= alive[i];
      }
    }
  }
  gags::cp_async_wait_all();
  float ga_tfin[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) ga_tfin[i] = ga[i] * T[i];

  // the cluster walks as many batches as its longest band
  if (threadIdx.x == 0) *s_batches = walked;
  cluster.sync();
  int nbatch = 0;
  for (int r = 0; r < bands; ++r) nbatch = max(nbatch, *cluster.map_shared_rank(s_batches, r));

  // ---- walk B: the gradients ---------------------------------------------
  float prefix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    prefix[i] = 0.0f;
    alive[i] = in_tile[i];
  }
  if (nbatch > 0)
    gags::stage_rows<C>(geom, colors, inst_gid, start, min(kBatch, count), s_geo, s_col);
  for (int b = 0; b < nbatch; ++b) {
    gags::cp_async_wait_all();
    // batch b has landed; every band is done reading the partials of b - 1
    cluster.sync();
    if (b + 1 < nbatch) {
      const int nxt = (b + 1) * kBatch;
      gags::stage_rows<C>(geom, colors, inst_gid, start + nxt, min(kBatch, count - nxt),
                          s_geo + ((b + 1) & 1) * kBatch * 8, s_col + ((b + 1) & 1) * kBatch * C);
    }
    const float* sg = s_geo + (b & 1) * kBatch * 8;
    const float* sc = s_col + (b & 1) * kBatch * C;
    const int nb = min(kBatch, count - b * kBatch);
    bool any = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    int k = 0;
    for (; k < nb && __any_sync(gags::kWarpMask, any); ++k) {
      const float4 g0 = reinterpret_cast<const float4*>(sg)[2 * k];
      const float2 g1 = reinterpret_cast<const float2*>(sg)[4 * k + 2];
      const float ca = g0.z, cb = g0.w, cc = g1.x;
      float col[C], geo[kGeomGrads];
#pragma unroll
      for (int c = 0; c < C; ++c) col[c] = 0.0f;
#pragma unroll
      for (int g = 0; g < kGeomGrads; ++g) geo[g] = 0.0f;
      bool blended = false;
      any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        float dx, dy, vis = 0.0f;
        const float sigma = gags::splat_sigma(px[i], py[i], g0.x, g0.y, ca, cb, cc, &dx, &dy);
        const float alpha =
            gags::surely_floored(sigma, g1.y) ? 0.0f : gags::alpha_of_sigma(sigma, g1.y, &vis);
        if (alpha != 0.0f) {
          const float next_t = gags::next_transmittance(T[i], alpha);
          if (next_t < gags::kTEps) {
            alive[i] = false;
          } else {
            const float w = gags::blend_weight(T[i], alpha);
            const float u = dot_rn<C>(gp[i], &sc[k * C]);
            prefix[i] = __fadd_rn(prefix[i], __fmul_rn(u, w));
            const float inv = __frcp_rn(1.0f - alpha);  // = 1 / (1 - alpha), correctly rounded
            const float dl_da = u * T[i] - (total[i] - prefix[i]) * inv + ga_tfin[i] * inv;
            if (alpha < gags::kAlphaClamp) {
              const float dl_ds = -alpha * dl_da;
              geo[0] += dl_ds * -(ca * dx + cb * dy);
              geo[1] += dl_ds * -(cc * dy + cb * dx);
              geo[2] += dl_ds * (0.5f * dx * dx);
              geo[3] += dl_ds * (dx * dy);
              geo[4] += dl_ds * (0.5f * dy * dy);
              geo[5] += dl_da * vis;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) col[c] += w * gp[i][c];
            blended = true;
            T[i] = next_t;
          }
        }
        any |= alive[i];
      }
      float* row = s_part + (k * warps + warp) * V;
      if (__any_sync(gags::kWarpMask, blended)) {
        gags::warp_sum_store<C>(col, lane, row);
        gags::warp_sum_store<kGeomGrads>(geo, lane, row + C);
      } else {
        for (int v = lane; v < V; v += 32) row[v] = 0.0f;
      }
    }
    for (; k < nb; ++k)  // the warp's pixels have all stopped
      for (int v = lane; v < V; v += 32) s_part[(k * warps + warp) * V + v] = 0.0f;
    // every band's partials of batch b are written
    cluster.sync();
    const size_t first = static_cast<size_t>(start + b * kBatch);
    gags::cluster_sums<V>(s_part, nb, bands, band, [&](int kk, int v, float s) {
      const size_t j = first + kk;
      if (v < C) grad_col[j * C + v] = s;
      else grad_geom[j * kGeomRow + (v - C)] = s;
    });
  }
  // no band leaves while another may still read its shared memory
  cluster.sync();
}

template <int C, int PPT>
int launch(const float* geom, const float* colors, const int* inst_gid,
           const int* tile_starts, const int* tile_counts, const int* tile_order,
           const float* gout,
           const float* galpha, float* grad_col, float* grad_geom,
           int num_tiles, int tiles_x, int tile_h, int tile_w,
           cudaStream_t stream) {
  gags::BandLayout L;
  if (!gags::band_layout(tile_h * tile_w, PPT, &L))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return gags::launch_tiles(blend_backward_full_kernel<C, PPT>, num_tiles, L,
                            smem_bytes<C>(L.threads / 32), stream, geom, colors, inst_gid,
                            tile_starts, tile_counts, tile_order, gout, galpha, grad_col, grad_geom,
                            tiles_x, tile_h, tile_w, L.bands);
}

// PPT = 2 is compiled for C <= 4 only (the registers of two cotangent
// rows)
template <int C>
int launch_ppt(int ppt, const float* geom, const float* colors, const int* inst_gid,
               const int* tile_starts, const int* tile_counts, const int* tile_order,
               const float* gout,
               const float* galpha, float* grad_col, float* grad_geom, int num_tiles,
               int tiles_x, int tile_h, int tile_w, cudaStream_t stream) {
  if constexpr (C <= kMaxPairedChannels) {
    if (ppt == 2)
      return launch<C, 2>(geom, colors, inst_gid, tile_starts, tile_counts, tile_order, gout,
                          galpha,
                          grad_col, grad_geom, num_tiles, tiles_x, tile_h, tile_w, stream);
  }
  return launch<C, 1>(geom, colors, inst_gid, tile_starts, tile_counts, tile_order, gout, galpha,
                      grad_col, grad_geom, num_tiles, tiles_x, tile_h, tile_w, stream);
}

// two pixels a thread where C <= 4 (the RGB trainer's C = 3), one where
// two cotangent rows would not fit the registers
int pixels_per_thread(int channels) { return channels <= kMaxPairedChannels ? 2 : 1; }

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

// geom (R, 8) f32, colors (R, C) f32 (both 16-byte aligned), inst_gid
// (M,) i32, tile_starts and tile_counts (num_tiles,) i32, tile_order
// (num_tiles,) i32 a permutation of the tiles (the order to start them
// in; the wrapper passes decreasing counts), gout
// (num_tiles, P, C) f32, galpha (num_tiles, P) f32 net of the background
// term; grad_col (M, C) and grad_geom (M, 8) f32 ZEROED (the kernel writes
// only the rows of the instances it walks). Launches on `stream` and
// returns the launch's CUDA error code.
int gags_blend_backward_full(const void* geom, const void* colors,
                             const void* inst_gid, const void* tile_starts,
                             const void* tile_counts, const void* tile_order,
                             const void* gout, const void* galpha, void* grad_col,
                             void* grad_geom, int num_tiles, int tiles_x,
                             int tile_h, int tile_w, int channels,
                             void* stream) {
  if (num_tiles <= 0) return 0;
  auto g = static_cast<const float*>(geom);
  auto col = static_cast<const float*>(colors);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto to = static_cast<const int*>(tile_order);
  auto go = static_cast<const float*>(gout);
  auto ga = static_cast<const float*>(galpha);
  auto gc = static_cast<float*>(grad_col);
  auto gg = static_cast<float*>(grad_geom);
  auto s = static_cast<cudaStream_t>(stream);
  const int ppt = pixels_per_thread(channels);
#define GAGS_CASE(CH)                                                             \
  case CH:                                                                        \
    return launch_ppt<CH>(ppt, g, col, id, ts, tc, to, go, ga, gc, gg, num_tiles, \
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
