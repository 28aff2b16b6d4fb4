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
// blend_common.cuh, which blend_backward.cu (K2) and blend_backward_full.cu
// (K8) share, so the backward retraces exactly the splats this kernel
// blended. An aligned range is an unaligned range that happens to start on
// a chunk: K1 walks [start, start + count) of the real instances, and the
// dummies after them (rank n, the zero row) would blend as no-ops anyway.
//
// Inputs are the rank-permuted tables the rasterizer builds: geometry
// (N+1, 8) [mx, my, ca, cb, cc, opac, 0, 0] and colours (N+1, C), each
// with a zero sentinel row, plus inst_gid (rank per instance slot), the
// per-tile ranges and the order in which to start the tiles. The kernel
// gathers each instance's rows through inst_gid itself; the TPU path's
// pre-gathered lane-major arrays, u16 halves, segment slack and head/tail
// lane masks are DMA artefacts that this kernel does not need.
//
// What bounds it on the H100: operations. Each (pixel, instance) pair
// costs ~12 float ops, plus one exp where the pixel is near the splat and
// 2C multiply-adds where it blends, against ~(8 + C) * 4 bytes of gathered
// rows per instance shared by a whole tile, so the pair count times the
// per-pair work dominates. Most walked pairs lie off the splat (94% of
// the training frame's never blend).
//
// Design (tile_reduce.cuh's layout and gathers, which K2 and K8 use too):
// a tile's pixels are split into bands (blocks) of at most 256 threads;
// each thread owns PPT pixels (pixels_per_thread: 2 up to C = 17, else 1)
// and each warp a compact block of 32 PPT pixels (8 wide, 4 PPT tall; 32
// consecutive pixels where the tile is no multiple of that), so that a
// splat tends to touch all of a warp's pixels or none. Batches of up to
// 128 instances are gathered into shared memory, batch b + 1 while batch b
// is walked (two buffers: waiting for each batch's gathers instead cost
// 1% on the training frame and 1-2% on the serving frame, beyond the
// spread of the turns; PERF.md), all with cp.async: the geometry rows (one
// 16-byte and one 8-byte shared load per instance, one read for all of a
// thread's pixels) and the colour rows; bf16 rows land in a buffer of their own and are
// widened to f32 once, so the walk never converts. As a thread's gathers
// land it also stores each of its instances' floored_outside box
// (blend_common.cuh): a warp whose pixel box misses the box skips the
// instance with one 16-byte load and four compares, exactly (every skipped
// pair would compute alpha = 0). The other pairs are tested first for the
// exact far-pair case (surely_floored: no exp). A thread stops walking once
// its pixels are all done, so a warp whose pixels are all done skips the
// rest of a batch (it still stages and meets every barrier), and a band
// stops once none of its pixels is alive (__syncthreads_count). Blocks
// take their tile from tile_order (the wrapper lists the tiles by
// decreasing instance count), so the longest walks start first and the
// short ones fill in behind them. Each pixel has one writer: a band whose
// pixels are one contiguous range of the tile assembles their C + 1
// values in shared memory and stores the range as one coalesced run (a
// pixel's row is 4 (C + 1) bytes, so stores straight from the threads
// touch a 32-byte sector per value); no atomics on the output, no
// cluster, bit-identical across launches.
// Each pixel adds its blended splats' weighted colours in range order
// (acc += w * colour; a splat that only the thread's other pixel blends
// adds w = 0 times its finite colour, which leaves acc's value alone), so
// the output depends on the range alone, not on which thread walks it or
// when.
//
// K5's inference options (kernels.blend_forward):
//   fast_color_rows  the colour table is bf16 (the wrapper rounds it to
//                    nearest even, as astype(jnp.bfloat16), and pads each
//                    row to a multiple of 8 values): the colour type is a
//                    template parameter; rows are widened to f32 (an exact
//                    conversion) as they are staged. Halves the colour bytes
//                    read from device memory at C = 8, 16 and 32.
//   blend_bf16       weights and colours enter the colour multiply-add as
//                    bf16, as the TPU's MXU operands do (its colour table is
//                    bf16 too). Their product is exact in f32 and the sum is
//                    f32. Transmittance stays f32 here: tighter than the TPU's
//                    bf16 LN-unit scan, so its contract (image max error <=
//                    5e-2 and mean <= 5e-3 of the image's scale, alpha atol
//                    0.03) holds a fortiori.
//   exit_stats       per-tile early-exit counters (a nullable pointer, not a
//                    template parameter): each pixel reports the chunk (of
//                    `chunk` instances, counted from the range's
//                    chunk-aligned base) that holds the splat where it
//                    stopped, or "never", and log2 of its naive T at that
//                    splat (of its final T when it never stopped); a max over
//                    a thread's pixels, a warp max and one atomicMax per warp
//                    and tile reduce them across the tile's bands (the log as
//                    an order-preserving int, since the raw bits of negative
//                    floats order backwards). The wrapper turns the two ints
//                    per tile into the TPU kernel's (T, 8, 128) block.
//   block_exit       no switch here: this kernel already retires per pixel,
//                    per warp and per band, so the flag is accepted and the
//                    output is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "blend_common.cuh"
#include "tile_reduce.cuh"

namespace {

constexpr int kMaxBatch = 128;  // instances staged per batch

// Two pixels a thread up to C = 17, one at C = 32 (64 accumulators):
// one geometry read and one box test serve both pixels, and the two give
// the thread independent work (build/ab_smoke.py on the H100, PERF.md:
// two won at C = 3 and 16, on the 240-tile training frame and the
// 920-tile serving frame).
constexpr int kMaxPaired = 17;
constexpr int pixels_per_thread(int c) { return c <= kMaxPaired ? 2 : 1; }

// Blocks of 256 threads an SM must hold (__launch_bounds__' second
// argument; 0 states none). f32 rows: none, the thread count alone; ptxas
// then picks 44-80 registers and spills nothing. bf16 rows: given the
// thread count alone, ptxas squeezes C = 2, 3 and 17 to the register
// counts at which one more block fits an SM (48 for five, 80 for three)
// and spills to reach them, so they state the count by the accumulators a
// thread holds (65536 / 256 / blocks registers: 48, 64, 80, 128). A stated
// count of one lifts ptxas' own squeeze too (f32 C = 16 took 88
// registers, two blocks). chip_smoke.py fails on a spill in this kernel,
// so the rule is checked on every build.
template <int C, typename Col, int PPT>
__host__ __device__ constexpr int min_blocks() {
  if (std::is_same<Col, float>::value) return 0;
  return C * PPT <= 2 ? 5 : C * PPT <= 8 ? 4 : C * PPT <= 32 ? 3 : 2;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x = fminf(x, __shfl_xor_sync(gags::kWarpMask, x, off));
  return x;
}

// log2 T as an int whose signed order is the float order (negative floats'
// raw bits order backwards); kernels.py undoes it
__device__ __forceinline__ int ordered_int(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// bf16 colour rows are C values padded to a multiple of 8 (16 bytes;
// the wrapper pads the table), so that they are gathered like f32 rows
template <int C>
__host__ __device__ constexpr int bf16_row() { return (C + 7) / 8 * 8; }

// colour c of a staged f32 row, read as float4 where the row allows
template <int C>
__device__ __forceinline__ void load_colours(const float* row, float (&col)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(row)[q];
      col[4 * q] = t.x;
      col[4 * q + 1] = t.y;
      col[4 * q + 2] = t.z;
      col[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) col[c] = row[c];
  }
}

// The gathers of one batch of nb instances (inst_gid entries gid[0, nb))
// into one buffer, by cp.async: geometry rows into sg (nb, 8); f32 colour
// rows into sc (nb, C), bf16 ones into raw (nb, bf16_row<C>()), widened
// by finish_batch.
template <int C, typename Col>
__device__ __forceinline__ void stage_batch(const float* __restrict__ geom,
                                            const Col* __restrict__ colors,
                                            const int* __restrict__ gid, int nb, float* sg,
                                            float* sc, Col* raw) {
  if constexpr (std::is_same<Col, float>::value) {
    gags::stage_rows<C>(geom, colors, gid, 0, nb, sg, sc);
  } else {
    constexpr int kRow = bf16_row<C>();
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      const Col* src = colors + static_cast<size_t>(gid[k]) * kRow;
#pragma unroll
      for (int q = 0; q < kRow; q += 8)
        gags::cp_async16(reinterpret_cast<float*>(raw + k * kRow + q),
                         reinterpret_cast<const float*>(src + q));
    }
    gags::stage_rows<0>(geom, nullptr, gid, 0, nb, sg, nullptr);  // commits both
  }
}

// Once a thread's gathers of a batch have landed: the floored_outside box
// of each instance it gathered, and its bf16 colour row widened to f32
// (exact) into sc.
template <int C, typename Col>
__device__ __forceinline__ void finish_batch(int nb, const float* sg, float4* sb, float* sc,
                                             const Col* raw) {
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    sb[k] = gags::floored_outside(sg + k * 8);
    if constexpr (!std::is_same<Col, float>::value) {
      if constexpr (C % 8 == 0) {  // 16-byte loads and stores: few bank conflicts
#pragma unroll
        for (int q = 0; q < C; q += 8) {
          const uint4 h = *reinterpret_cast<const uint4*>(raw + k * C + q);
          const unsigned w[4] = {h.x, h.y, h.z, h.w};
          float4* d = reinterpret_cast<float4*>(sc + k * C + q);
          // little-endian: value 2j is the low half of word j; bf16 is the
          // high half of an f32
          d[0] = make_float4(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                             __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u));
          d[1] = make_float4(__uint_as_float(w[2] << 16), __uint_as_float(w[2] & 0xffff0000u),
                             __uint_as_float(w[3] << 16), __uint_as_float(w[3] & 0xffff0000u));
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) sc[k * C + c] = __bfloat162float(raw[k * bf16_row<C>() + c]);
      }
    }
  }
}

template <int C, typename Col, int PPT>
__global__ void __launch_bounds__(gags::kBandThreads, min_blocks<C, Col, PPT>())
blend_forward_kernel(const float* __restrict__ geom,
                     const Col* __restrict__ colors,
                     const int* __restrict__ inst_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const int* __restrict__ tile_order,
                     const float* __restrict__ bg, float* __restrict__ out,
                     int* __restrict__ stats, int tiles_x, int tile_h,
                     int tile_w, int bands, int batch, int bf16_weights, int chunk) {
  extern __shared__ float4 smem4[];
  float* s_geo = reinterpret_cast<float*>(smem4);  // [2][batch][8]
  float4* s_box = smem4 + 2 * batch * 2;            // [2][batch] floored_outside
  float* s_col = reinterpret_cast<float*>(s_box + 2 * batch);  // [2][batch][C] f32
  Col* s_raw = reinterpret_cast<Col*>(s_col + 2 * batch * C);  // bf16: [batch][row]

  const int tile = tile_order[blockIdx.x / bands];
  const int band = blockIdx.x - (blockIdx.x / bands) * bands;
  const int warps = blockDim.x >> 5;
  const int unit = band * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int npix = tile_h * tile_w;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int batches = (count + batch - 1) / batch;

  float px[PPT], py[PPT], T[PPT], acc[PPT][C];
  bool alive[PPT];
  // exit_stats: the largest chunk + 1 of a stopping splat and log2 of the
  // naive T just after it, over the thread's pixels that stopped
  int chunk1 = 0, lt = INT_MIN;
  float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;  // the pixels' box
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = gags::tile_pixel<PPT>(unit, i, lane, tile_w, tile_h);
    alive[i] = p < npix;
    gags::pixel_centre(tile, p, tiles_x, tile_h, tile_w, &px[i], &py[i]);
    if (alive[i]) {
      x0 = fminf(x0, px[i]);
      x1 = fmaxf(x1, px[i]);
      y0 = fminf(y0, py[i]);
      y1 = fmaxf(y1, py[i]);
    }
    T[i] = 1.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }
  // the warp's pixel box: a splat floored outside a box that misses it is
  // skipped by the whole warp at once (pixel centres are exact in float,
  // so the min and max are too)
  x0 = warp_min(x0);
  y0 = warp_min(y0);
  x1 = -warp_min(-x1);
  y1 = -warp_min(-y1);

  // batch b into buffer b & 1 (the bf16 landing rows: one buffer, widened
  // before the barrier after which the next batch's gathers start)
  const auto stage = [&](int b) {
    stage_batch<C>(geom, colors, inst_gid + start + b * batch, min(batch, count - b * batch),
                   s_geo + (b & 1) * batch * 8, s_col + (b & 1) * batch * C, s_raw);
  };
  if (batches > 0) stage(0);
  for (int b = 0; b < batches; ++b) {
    gags::cp_async_wait_all();  // this thread's gathers of batch b have landed
    finish_batch<C, Col>(min(batch, count - b * batch), s_geo + (b & 1) * batch * 8,
                         s_box + (b & 1) * batch, s_col + (b & 1) * batch * C, s_raw);
    bool any = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // batch b is visible to all, every warp is done with batch b - 1; stop
    // once no pixel of the band is alive
    if (__syncthreads_count(any) == 0) break;
    if (b + 1 < batches) stage(b + 1);
    if (!any) continue;  // this thread's pixels are done: stage, meet barriers
    const int b0 = b * batch;
    const int nb = min(batch, count - b0);
    const float* sg = s_geo + (b & 1) * batch * 8;
    const float4* sb = s_box + (b & 1) * batch;
    const float* sc = s_col + (b & 1) * batch * C;
    for (int k = 0; k < nb; ++k) {
      const float4 box = sb[k];  // uniform over the warp: no divergence
      if (box.x > x1 || box.y < x0 || box.z > y1 || box.w < y0) continue;
      const float4 g0 = reinterpret_cast<const float4*>(sg)[2 * k];  // mx, my, ca, cb
      const float2 g1 = reinterpret_cast<const float2*>(sg)[4 * k + 2];  // cc, opac
      float alpha[PPT];
      bool hit = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        alpha[i] = 0.0f;
        if (alive[i]) {
          float dx, dy, vis;
          const float sigma =
              gags::splat_sigma(px[i], py[i], g0.x, g0.y, g0.z, g0.w, g1.x, &dx, &dy);
          if (!gags::surely_floored(sigma, g1.y))
            alpha[i] = gags::alpha_of_sigma(sigma, g1.y, &vis);
          hit |= alpha[i] != 0.0f;
        }
      }
      if (!hit) continue;
      float w[PPT];
      bool still = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        w[i] = 0.0f;
        if (alpha[i] != 0.0f) {
          const float next_t = gags::next_transmittance(T[i], alpha[i]);
          if (next_t < gags::kTEps) {
            alive[i] = false;
            if (stats != nullptr) {  // the chunk after the stopping splat's
              chunk1 = max(chunk1, (start % chunk + b0 + k) / chunk + 1);
              lt = max(lt, ordered_int(log2f(next_t)));
            }
          } else {
            w[i] = gags::blend_weight(T[i], alpha[i]);
            if (bf16_weights) w[i] = __bfloat162float(__float2bfloat16(w[i]));
            T[i] = next_t;
          }
        }
        still |= alive[i];
      }
      float col[C];
      load_colours<C>(sc + k * C, col);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += w[i] * col[c];
      }
      if (!still) break;
    }
  }
  gags::cp_async_wait_all();

  // The output rows (C + 1 floats a pixel). Where the band's pixels are
  // one contiguous range of the tile (whole rows of 8x4 blocks, or runs of
  // 32 pixels), they are assembled in shared memory (the launch sizes it to
  // hold them) and stored as one coalesced run; otherwise each thread
  // stores its own pixels' rows.
  int pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) pix[i] = gags::tile_pixel<PPT>(unit, i, lane, tile_w, tile_h);
  __shared__ int s_range[3];  // lowest pixel, highest pixel, pixels
  if (threadIdx.x == 0) {
    s_range[0] = INT_MAX;
    s_range[1] = -1;
    s_range[2] = 0;
  }
  __syncthreads();  // also: no warp reads the staged rows any more
  int mine = 0;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (pix[i] < npix) {
      atomicMin(&s_range[0], pix[i]);
      atomicMax(&s_range[1], pix[i]);
      ++mine;
    }
  }
  if (mine > 0) atomicAdd(&s_range[2], mine);
  __syncthreads();
  const int lo = s_range[0];
  const int n_out = s_range[2];
  const bool packed = n_out > 0 && s_range[1] - lo + 1 == n_out;  // one contiguous range
  float* o_tile = out + static_cast<size_t>(tile) * npix * (C + 1);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (pix[i] < npix) {
      float* o = packed ? reinterpret_cast<float*>(smem4) + (pix[i] - lo) * (C + 1)
                        : o_tile + static_cast<size_t>(pix[i]) * (C + 1);
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = acc[i][c] + T[i] * bg[c];
      o[C] = 1.0f - T[i];
    }
  }
  if (packed) {
    __syncthreads();
    const float* src = reinterpret_cast<const float*>(smem4);
    float* dst = o_tile + static_cast<size_t>(lo) * (C + 1);
    for (int j = threadIdx.x; j < n_out * (C + 1); j += blockDim.x) dst[j] = src[j];
  }

  if (stats != nullptr) {  // uniform over the block: every lane reaches here
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pix[i] < npix && alive[i]) {  // never stopped: "never" (INT_MAX), its final T
        chunk1 = INT_MAX;
        lt = max(lt, ordered_int(log2f(T[i])));
      }
    }
    chunk1 = __reduce_max_sync(gags::kWarpMask, chunk1);
    lt = __reduce_max_sync(gags::kWarpMask, lt);
    if (lane == 0) {
      atomicMax(stats + 2 * tile, chunk1);
      atomicMax(stats + 2 * tile + 1, lt);
    }
  }
}

template <int C, typename Col>
int launch(const float* geom, const void* colors, const int* inst_gid,
           const int* tile_starts, const int* tile_counts, const int* tile_order,
           const float* bg, float* out, int* stats, int num_tiles, int tiles_x, int tile_h,
           int tile_w, int bf16_weights, int chunk, cudaStream_t stream) {
  constexpr int kPpt = pixels_per_thread(C);
  const int need = (tile_h * tile_w + kPpt - 1) / kPpt;  // threads a tile
  int threads = need < gags::kBandThreads ? need : gags::kBandThreads;
  threads = (threads + 31) / 32 * 32;
  const int bands = (need + threads - 1) / threads;
  const int batch = threads < kMaxBatch ? threads : kMaxBatch;
  // the staged rows, or the band's output rows where they need more
  size_t smem = static_cast<size_t>(2 * batch) * (8 + 4 + C) * sizeof(float);
  if (!std::is_same<Col, float>::value) smem += static_cast<size_t>(batch) * bf16_row<C>() * 2;
  const size_t rows = static_cast<size_t>(threads) * kPpt * (C + 1) * sizeof(float);
  smem = smem > rows ? smem : rows;
  auto kernel = blend_forward_kernel<C, Col, kPpt>;
  if (smem > 48 * 1024) {  // C = 32 with bf16 rows
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<num_tiles * bands, threads, smem, stream>>>(
      geom, static_cast<const Col*>(colors), inst_gid, tile_starts, tile_counts, tile_order,
      bg, out, stats, tiles_x, tile_h, tile_w, bands, batch, bf16_weights, chunk);
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
             const void* tile_starts, const void* tile_counts, const void* tile_order,
             const void* bg, void* out, void* stats, int num_tiles, int tiles_x, int tile_h,
             int tile_w, int channels, int bf16_weights, int chunk, void* stream) {
  auto g = static_cast<const float*>(geom);
  auto id = static_cast<const int*>(inst_gid);
  auto ts = static_cast<const int*>(tile_starts);
  auto tc = static_cast<const int*>(tile_counts);
  auto to = static_cast<const int*>(tile_order);
  auto b = static_cast<const float*>(bg);
  auto o = static_cast<float*>(out);
  auto st = static_cast<int*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
#define GAGS_CASE(CH)                                                               \
  case CH:                                                                          \
    return launch<CH, Col>(g, colors, id, ts, tc, to, b, o, st, num_tiles, tiles_x, \
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

// K5. geom (R, 8) f32 and colors (R, C) f32 or, with bf16_colors, (R,
// bf16_row<C>()) bf16 (C values, then zeros to a multiple of 8), both
// 16-byte aligned; inst_gid (M,) i32, tile_starts and tile_counts
// (num_tiles,) i32, bg (C,) f32, out (num_tiles, P, C+1) f32; stats null
// or (num_tiles, 2) i32 initialised to (0, INT_MIN), which receives per
// tile the largest stopping chunk + 1 (INT_MAX: some pixel never stopped)
// and the largest log2 T as an ordered int; chunk: the instances per chunk
// those count. bf16_weights rounds every blend weight to bf16 before the
// colour multiply-add. tile_order (num_tiles,) i32, a permutation of the
// tiles: the order to start them in (the wrapper passes decreasing
// counts). Launches on `stream` and returns cudaGetLastError() of the
// launch.
int gags_blend_forward(const void* geom, const void* colors,
                       const void* inst_gid, const void* tile_starts,
                       const void* tile_counts, const void* bg, void* out,
                       void* stats, int num_tiles, int tiles_x, int tile_h,
                       int tile_w, int channels, int bf16_colors,
                       int bf16_weights, int chunk, void* stream, const void* tile_order) {
  if (num_tiles <= 0) return 0;
  if (stats != nullptr && chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_colors) {
    return dispatch<__nv_bfloat16>(geom, colors, inst_gid, tile_starts, tile_counts,
                                   tile_order, bg, out, stats, num_tiles, tiles_x, tile_h,
                                   tile_w, channels, bf16_weights, chunk, stream);
  }
  return dispatch<float>(geom, colors, inst_gid, tile_starts, tile_counts, tile_order, bg,
                         out, stats, num_tiles, tiles_x, tile_h, tile_w, channels,
                         bf16_weights, chunk, stream);
}

// K1, over an aligned binning (chunk-aligned starts, tile_counts = the real
// instances of each range): f32 colours, no options; the other arguments
// as K5's.
int gags_blend_forward_aligned(const void* geom, const void* colors,
                               const void* inst_gid, const void* tile_starts,
                               const void* tile_counts, const void* bg,
                               void* out, int num_tiles, int tiles_x,
                               int tile_h, int tile_w, int channels,
                               void* stream, const void* tile_order) {
  if (num_tiles <= 0) return 0;
  return dispatch<float>(geom, colors, inst_gid, tile_starts, tile_counts, tile_order, bg,
                         out, nullptr, num_tiles, tiles_x, tile_h, tile_w, channels, 0, 0,
                         stream);
}

}  // extern "C"
