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
// Design: K8's walk B without the geometry, in tile_reduce.cuh's layout.
// A tile is a thread-block cluster of bands of 256 threads; each thread
// owns two pixels with their cotangent rows in registers (C is a template
// parameter) and each warp a compact 8x8 block, so that for most
// instances no lane of a warp blends. Batches of instance geometry rows
// are gathered with cp.async, batch b + 1 while batch b is walked; every
// warp walks a batch in lock step (a pixel that has stopped contributes
// w = 0), testing each pair first for the exact far-pair case
// (blend_common.cuh's surely_floored: no exp). A warp in which no pixel
// blends an instance writes zeros; otherwise each thread adds its two
// pixels' products in registers and the warp reduces the C sums by a
// transpose-reduce (C = 16: 16 shuffles where a shuffle tree per channel
// took 80), each landing in its own lane, into its row of the band's
// partials. After a cluster barrier the tile sums every (instance,
// channel) over its warps in a fixed order and stores it: one writer per
// output row, no atomics, bit-identical across launches. The cluster
// stops once none of its pixels is alive; the tiles start in order of
// decreasing instance count.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "tile_reduce.cuh"

namespace {

// shared memory of a band: the double-buffered geometry rows, the
// partials and the band's live flag
template <int C>
size_t smem_bytes(int warps) {
  constexpr int kBatch = gags::batch_for(C);
  return (static_cast<size_t>(2 * kBatch) * 8 + static_cast<size_t>(kBatch) * warps * C) *
             sizeof(float) + 16;
}

template <int C, int PPT>
__global__ void __launch_bounds__(gags::kBandThreads)
blend_backward_kernel(const float* __restrict__ geom,
                      const int* __restrict__ inst_gid,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_counts,
                      const int* __restrict__ tile_order,
                      const float* __restrict__ gout,
                      float* __restrict__ grad, int tiles_x, int tile_h,
                      int tile_w, int bands) {
  constexpr int kBatch = gags::batch_for(C);
  gags::cg::cluster_group cluster = gags::cg::this_cluster();
  const int band = static_cast<int>(cluster.block_rank());
  const int tile = tile_order[blockIdx.x / bands];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float4 smem4[];
  float* s_geo = reinterpret_cast<float*>(smem4);  // [2][kBatch][8]
  float* s_part = s_geo + 2 * kBatch * 8;           // [kBatch][warps][C]
  int* s_live = reinterpret_cast<int*>(s_part + kBatch * warps * C);

  const int npix = tile_h * tile_w;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int batches = (count + kBatch - 1) / kBatch;

  float px[PPT], py[PPT], gp[PPT][C], T[PPT];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = gags::tile_pixel<PPT>(band * warps + warp, i, lane, tile_w, tile_h);
    alive[i] = p < npix;
    gags::pixel_centre(tile, p, tiles_x, tile_h, tile_w, &px[i], &py[i]);
    const float* grow = gout + (static_cast<size_t>(tile) * npix + p) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) gp[i][c] = alive[i] ? grow[c] : 0.0f;
    T[i] = 1.0f;
  }

  if (batches > 0)
    gags::stage_rows<0>(geom, nullptr, inst_gid, start, min(kBatch, count), s_geo, nullptr);
  for (int b = 0; b < batches; ++b) {
    gags::cp_async_wait_all();
    bool any = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // does any pixel of the band still blend? (also: batch b has landed)
    const int live = __syncthreads_or(any);
    if (threadIdx.x == 0) s_live[b & 1] = live;
    // every band's flag is written, and every band is done reading the
    // partials of b - 1
    cluster.sync();
    bool any_live = false;
    for (int r = 0; r < bands; ++r) any_live |= *cluster.map_shared_rank(s_live + (b & 1), r) != 0;
    if (!any_live) break;  // uniform across the cluster
    if (b + 1 < batches) {
      const int nxt = (b + 1) * kBatch;
      gags::stage_rows<0>(geom, nullptr, inst_gid, start + nxt, min(kBatch, count - nxt),
                          s_geo + ((b + 1) & 1) * kBatch * 8, nullptr);
    }
    const float* sg = s_geo + (b & 1) * kBatch * 8;
    const int nb = min(kBatch, count - b * kBatch);
    int k = 0;
    for (; k < nb && __any_sync(gags::kWarpMask, any); ++k) {
      const float4 g0 = reinterpret_cast<const float4*>(sg)[2 * k];
      const float2 g1 = reinterpret_cast<const float2*>(sg)[4 * k + 2];
      float w[PPT];
      bool blended = false;
      any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        w[i] = 0.0f;
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
            w[i] = gags::blend_weight(T[i], alpha);
            blended = true;
            T[i] = next_t;
          }
        }
        any |= alive[i];
      }
      float* row = s_part + (k * warps + warp) * C;
      if (__any_sync(gags::kWarpMask, blended)) {
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[c] = w[0] * gp[0][c];
#pragma unroll
          for (int i = 1; i < PPT; ++i) v[c] += w[i] * gp[i][c];
        }
        gags::warp_sum_store<C>(v, lane, row);
      } else if (lane < C) {
        row[lane] = 0.0f;
      }
    }
    for (; k < nb; ++k)  // the warp's pixels have all stopped
      if (lane < C) s_part[(k * warps + warp) * C + lane] = 0.0f;
    // every band's partials of batch b are written
    cluster.sync();
    float* out = grad + static_cast<size_t>(start + b * kBatch) * C;
    gags::cluster_sums<C>(s_part, nb, bands, band,
                          [&](int kk, int c, float s) { out[static_cast<size_t>(kk) * C + c] = s; });
  }
  gags::cp_async_wait_all();
  // no band leaves while another may still read its shared memory
  cluster.sync();
}

template <int C, int PPT>
int launch(const float* geom, const int* inst_gid, const int* tile_starts,
           const int* tile_counts, const int* tile_order, const float* gout, float* grad,
           int num_tiles, int tiles_x, int tile_h, int tile_w, cudaStream_t stream) {
  gags::BandLayout L;
  if (!gags::band_layout(tile_h * tile_w, PPT, &L))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return gags::launch_tiles(blend_backward_kernel<C, PPT>, num_tiles, L,
                            smem_bytes<C>(L.threads / 32), stream, geom, inst_gid, tile_starts,
                            tile_counts, tile_order, gout, grad, tiles_x, tile_h, tile_w, L.bands);
}

// two pixels a thread: half the per-instance overhead and warp
// reductions of one (at GAD's 240 tiles of 32x32, though they hold half
// the warps)
constexpr int kPixelsPerThread = 2;

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

// geom (R, 8) f32 (16-byte aligned), inst_gid (M,) i32, tile_starts and
// tile_counts (num_tiles,) i32, tile_order (num_tiles,) i32 a permutation
// of the tiles (the order to start them in; the wrapper passes decreasing
// counts), gout (num_tiles, P, C) f32, grad (M, C)
// f32 ZEROED (the kernel writes only the rows of the instances it walks).
// Launches on `stream` and returns the launch's CUDA error code.
int gags_blend_backward(const void* geom, const void* inst_gid,
                        const void* tile_starts, const void* tile_counts,
                        const void* tile_order, const void* gout, void* grad, int num_tiles,
                        int tiles_x, int tile_h, int tile_w, int channels,
                        void* stream) {
  if (num_tiles <= 0) return 0;
  auto g = static_cast<const float*>(geom);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto to = static_cast<const int*>(tile_order);
  auto go = static_cast<const float*>(gout);
  auto gr = static_cast<float*>(grad);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                       \
  case CH:                                                                  \
    return launch<CH, kPixelsPerThread>(g, id, ts, tc, to, go, gr, num_tiles, \
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
