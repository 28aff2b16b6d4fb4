// tile_reduce.cuh: the layout and the reductions that the two backward
// blends share (blend_backward.cu: K2; blend_backward_full.cu: K8), beside
// blend_common.cuh's per-pair arithmetic. The forward blend
// (blend_forward.cu: K1 and K5) takes the layout (`tile_pixel`) and the
// gathers (`stage_rows`) without the cluster and the reductions.
//
// A tile is one thread-block cluster (sm_90) of `bands` blocks of at most
// kBandThreads threads; each thread owns PPT pixels and each warp a
// compact block of 32 PPT pixels (`tile_pixel`: 8 wide, 4 PPT tall where
// the tile allows), so that for most instances either no lane of a warp
// blends, and the warp skips the instance, or many do. Instances are walked in batches
// whose geometry (and colour) rows are gathered into shared memory with
// cp.async, double-buffered: batch b + 1 is in flight while batch b is
// walked. For every instance of a batch, each warp reduces its V values
// over its lanes (`warp_sum_store`) into its own row of the band's
// partials (batch, warps, V) in shared memory; after a cluster barrier,
// `cluster_sums` adds each (instance, value) over the tile's warps in band
// order, then warp order, reading the other bands' partials through
// distributed shared memory, and the tile stores the sum with a plain
// store. So every output row has one writer and a fixed order of
// addition: two launches give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gags {

namespace cg = cooperative_groups;

constexpr int kBandThreads = 256;  // threads of a band (one block)
constexpr int kMaxBands = 8;       // the portable cluster size
constexpr unsigned kWarpMask = 0xffffffffu;

// instances per batch for V values an instance: the partials (batch,
// warps, V) and the staged rows stay well inside the default 48 KiB
__host__ __device__ constexpr int batch_for(int v) { return v <= 16 ? 64 : v <= 32 ? 32 : 16; }

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// ---- the layout --------------------------------------------------------------

// The pixel (row-major in the tile) of `lane` in the i-th 32-pixel group
// of warp `unit` (band * warps + warp): the 8x4 block i of the unit's
// 8 x 4 PPT column of blocks where the tile's width is a multiple of 8 and
// its height of 4 PPT; else 32 consecutive pixels. Pixels past the tile
// (p >= tile_h tile_w) belong to no one.
template <int PPT>
__device__ __forceinline__ int tile_pixel(int unit, int i, int lane, int tile_w, int tile_h) {
  if (tile_w % 8 == 0 && tile_h % (4 * PPT) == 0) {
    const int blocks_x = tile_w / 8;
    const int bx = unit % blocks_x;
    const int by = (unit / blocks_x) * PPT + i;
    return (by * 4 + (lane >> 3)) * tile_w + bx * 8 + (lane & 7);
  }
  return (unit * PPT + i) * 32 + lane;
}

// ---- cp.async gathers ------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the gathers of the geometry rows (8 floats, 16-byte aligned) and,
// for C > 0, the colour rows of instances first .. first + nb - 1 into
// s_geo (nb, 8) and s_col (nb, C): one instance per thread, one commit
// group per call. The caller waits (cp_async_wait_all) and then passes a
// block barrier before reading them.
template <int C>
__device__ __forceinline__ void stage_rows(const float* __restrict__ geom,
                                           const float* __restrict__ colors,
                                           const int* __restrict__ inst_gid, int first, int nb,
                                           float* s_geo, float* s_col) {
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    const size_t r = static_cast<size_t>(inst_gid[first + k]);
    const float* g = geom + r * 8;
    cp_async16(s_geo + k * 8, g);
    cp_async16(s_geo + k * 8 + 4, g + 4);
    if constexpr (C > 0) {
      const float* col = colors + r * C;
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int q = 0; q < C; q += 4) cp_async16(s_col + k * C + q, col + q);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) cp_async4(s_col + k * C + c, col + c);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---- the warp's transpose-reduce ------------------------------------------

// At each butterfly step a lane keeps one half of its remaining values
// and sends the other half to its partner, so W values (a power of two)
// cost W/2 + W/4 + ... + 1 shuffles, then one per remaining lane bit.
template <int H, int OFF, int W>
__device__ __forceinline__ void transpose_steps(float (&a)[W], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? a[i] : a[i + H];
      const float keep = up ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(kWarpMask, send, OFF);
    }
    transpose_steps<H / 2, OFF / 2, W>(a, lane);
  } else if constexpr (OFF >= 1) {
    a[0] += __shfl_xor_sync(kWarpMask, a[0], OFF);
    transpose_steps<0, OFF / 2, W>(a, lane);
  }
}

// Sums each of the N <= 32 values v[0..N) over the warp's 32 lanes and
// stores sum n at dst[n], each from one lane, in a fixed order of
// addition. Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void warp_sum_store(const float (&v)[N], int lane, float* dst) {
  static_assert(N >= 1 && N <= 32, "warp_sum_store: 1 to 32 values");
  constexpr int W = pow2_at_least(N);
  constexpr int kShift = 5 - log2_of(W);  // lane bits left after the transpose
  float a[W];
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = i < N ? v[i] : 0.0f;
  transpose_steps<W / 2, 16, W>(a, lane);
  const int idx = lane >> kShift;  // the value this lane now holds
  if ((lane & ((1 << kShift) - 1)) == 0 && idx < N) dst[idx] = a[0];
}

// ---- the tile's sums -------------------------------------------------------

// After the cluster barrier that follows a batch's walk: every (instance
// k < nb, value v < V) of the batch summed over the tile's warps, band by
// band and warp by warp, from each band's partials s_part (batch, warps,
// V); the work is spread over the cluster's threads, and store(k, v, sum)
// writes each sum once.
template <int V, typename Store>
__device__ __forceinline__ void cluster_sums(const float* s_part, int nb, int bands, int band,
                                             Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  const int warps = blockDim.x >> 5;
  for (int idx = band * blockDim.x + threadIdx.x; idx < nb * V; idx += bands * blockDim.x) {
    const int k = idx / V;
    const int v = idx - k * V;
    float s = 0.0f;
    for (int r = 0; r < bands; ++r) {
      const float* p = cluster.map_shared_rank(s_part, r) + k * warps * V + v;
      for (int w = 0; w < warps; ++w) s += p[w * V];
    }
    store(k, v, s);
  }
}

// ---- the launch -------------------------------------------------------------

struct BandLayout {
  int threads;  // per band, a multiple of 32
  int bands;    // per tile: the cluster's size
};

// The bands of a tile of npix pixels at ppt pixels a thread; false where
// the tile needs more than kMaxBands bands.
inline bool band_layout(int npix, int ppt, BandLayout* out) {
  const int need = (npix + ppt - 1) / ppt;  // threads
  int threads = need < kBandThreads ? need : kBandThreads;
  threads = (threads + 31) / 32 * 32;
  out->threads = threads;
  out->bands = (need + threads - 1) / threads;
  return out->bands <= kMaxBands;
}

// Launches kernel over num_tiles clusters of L.bands blocks each; cluster
// c takes the tile tile_order[c] (the wrapper lists the tiles by
// decreasing instance count, so the longest walks start first and the
// short ones fill in behind them).
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), int num_tiles, BandLayout L, size_t smem,
                 cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(num_tiles * L.bands));
  cfg.blockDim = dim3(static_cast<unsigned>(L.threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(L.bands);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace gags
