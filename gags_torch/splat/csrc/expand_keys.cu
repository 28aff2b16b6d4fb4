// expand_keys: the fused ragged->dense expansion and sort-key construction
// of the unaligned (inference) binning, with the optional exact
// ellipse-tile cull.
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:expand_keys
// (body _expand_keys_kernel), which does in one pass what the unfused
// binning does with K6 (expand_gid), an M-row gather of per-rank data and
// an elementwise key chain. For every instance slot i < num_slots:
//
//   g      = clip(#{j < n : offsets[j] <= i} - 1, 0, n - 1)   (owning rank)
//   slot   = i - offsets[g];  dy = floor(slot / pw);  dx = slot - dy * pw
//   tile   = (y0 + dy) * tiles_x + (x0 + dx)   with (x0, y0, pw) unpacked
//            from packed[g] = x0 | y0 << 10 | max(w, 1) << 20
//   valid  = i < num_valid  and  (no cull  or  ellipse_keep(tile, cull[g]))
//   key    = valid ? (tile << shift) | g : INT64_MAX
//
// plus the valid count of every 1024-slot chunk. The port sorts int64
// keys, so the JAX package's int32 / uint32 tiers are one case here with
// the same order; INT64_MAX fillers sort after every real key. The slot
// arithmetic is int64 where int32 could wrap, and the division floors, as
// the plain version's does (a slot below offsets[0] is negative).
//
// The cull (tiles.ellipse_tile_keep) keeps a (Gaussian, tile) instance
// iff some pixel centre of the tile can reach sigma <= L = ln(255 o_eff):
// the minimum of the quadratic form over the tile's pixel-centre rectangle
// is 0 when the mean is inside, else it lies on an edge, where the 1-D
// minimiser has a closed form. It must take the plain version's decisions
// bit for bit (kernels.ellipse_tile_keep), so every operation is written
// with a round-to-nearest intrinsic in the plain version's order (nvcc
// would otherwise contract a*b + c into an FMA and flip keep/drop at the
// boundary), and the clip and the minima propagate NaN as torch.minimum /
// torch.maximum do (fminf / fmaxf would drop it where -b ub / c is 0/0).
//
// What bounds it on the H100: bytes (an 8 B key a slot; each rank's offset
// and packed rect, and with the cull its 24 B row, read once). What held
// the first design back was latency: one thread per slot ran K6's
// per-slot binary search over `offsets` in global memory (~18-20
// dependent L2 round trips), then gathered offsets[g], packed[g] and the
// cull row once per slot, over ~4 waves of 1024-thread blocks.
//
// Design: owner_window.cuh's owners, one search per tile of 2048 slots
// (two 1024-slot chunks): warps 0 and 1 find the tile's first and last
// owner, the ranks between them mark their first slots in shared memory
// and a block prefix maximum gives each slot its owner. The same pass of
// 16-byte loads keeps the offsets and packed rects of those ranks in
// shared memory, where each slot reads its owner's. A thread holds 2
// consecutive slots a round (a warp 64, a run of 256 over its 4 rounds),
// stores their keys as one 16-byte store, and divides once: the second
// slot is one step along the first's rect row, or the first slot (0, 0)
// of the next rank. A chunk's count is the sum of per-warp ballot
// popcounts. The cull rows are not kept in shared memory: they are read
// only for slots below num_valid, where a warp's slots belong to a few
// consecutive ranks, so its gather covers their rows once; keeping them
// would quadruple the window's shared memory and cut the blocks an SM
// holds (loading a round's rows a round ahead gained nothing on the H100:
// the cull is bound by its arithmetic). The grid is one wave, each block
// looping over tiles. Exact on any monotone offsets: see owner_window.cuh
// (runs of empty ranks, slots below offsets[0] or past offsets[n - 1]).

#include <cuda_runtime.h>
#include <stdint.h>

#include "owner_window.cuh"

namespace {

constexpr int kChunk = 1024;  // slots a valid count
constexpr int kThreads = 256;
constexpr int kVec = 2;  // slots a thread a round: one 16-byte store of two keys
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kVec * kRounds;  // 2048 slots, two chunks
constexpr int kWarpSlots = 32 * kVec * kRounds;   // 256: a chunk is four warps' runs
constexpr int kWindow = kTile;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}

// jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x))
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return min_nan(hi, max_nan(lo, x));
}

// sigma at the minimiser along a vertical edge u = ub (v free in [v0, v1]):
// vs = clip(-b ub / c, v0, v1); (0.5 a ub + b vs) ub + 0.5 c vs vs
__device__ __forceinline__ float edge_min(float ub, float lo, float hi,
                                          float a, float b, float c) {
  const float vs = clip_nan(__fdiv_rn(__fmul_rn(-b, ub), c), lo, hi);
  const float lin = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, a), ub), __fmul_rn(b, vs));
  return __fadd_rn(__fmul_rn(lin, ub), __fmul_rn(__fmul_rn(__fmul_rn(0.5f, c), vs), vs));
}

// tiles.ellipse_tile_keep for one (tile (tx, ty) as floats, cull row
// [mx, my, a, b, c, L])
__device__ __forceinline__ bool ellipse_keep(float tx, float ty, int tile_w, int tile_h,
                                             const float2* __restrict__ row) {
  const float2 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  const float mx = r0.x, my = r0.y, a = r1.x, b = r1.y, c = r2.x, lvl = r2.y;
  const float u0 = __fsub_rn(__fadd_rn(__fmul_rn(tx, static_cast<float>(tile_w)), 0.5f), mx);
  const float u1 = __fadd_rn(u0, static_cast<float>(tile_w - 1));
  const float v0 = __fsub_rn(__fadd_rn(__fmul_rn(ty, static_cast<float>(tile_h)), 0.5f), my);
  const float v1 = __fadd_rn(v0, static_cast<float>(tile_h - 1));
  const bool inside = (u0 <= 0.0f) && (0.0f <= u1) && (v0 <= 0.0f) && (0.0f <= v1);
  // edges u = u0, u1 minimise over v; edges v = v0, v1 over u (a and c swap)
  const float smin = min_nan(min_nan(edge_min(u0, v0, v1, a, b, c),
                                     edge_min(u1, v0, v1, a, b, c)),
                             min_nan(edge_min(v0, u0, u1, c, b, a),
                                     edge_min(v1, u0, u1, c, b, a)));
  return inside || (smin <= lvl);
}

struct KeyArgs {
  const float* cull;
  int nv, shift, tiles_x, tile_w, tile_h;
};

// Slot i of a rank whose first slot is og and whose rect is pk lies in
// tile (x0 + dx, y0 + dy): dy = floor((i - og) / pw), dx = (i - og) - dy pw.
__device__ __forceinline__ void slot_step(int i, int og, int pk, int& dx, long long& dy) {
  const int pw = (pk >> 20) & 1023;
  const long long slot = static_cast<long long>(i) - og;
  if (slot >= 0) {  // < 2^32: one unsigned 32-bit division
    const unsigned q = static_cast<unsigned>(slot) / static_cast<unsigned>(pw);
    dy = q;
    dx = static_cast<int>(static_cast<unsigned>(slot) - q * static_cast<unsigned>(pw));
  } else {  // below offsets[0]: floor, as torch.div(rounding_mode="floor")
    dy = slot / pw;
    long long rem = slot - dy * pw;
    if (rem < 0) {
      dy -= 1;
      rem += pw;
    }
    dx = static_cast<int>(rem);
  }
}

// The key of a slot of rank g (rect pk) at step (dx, dy) of its rect.
template <bool kCull>
__device__ __forceinline__ long long slot_key(int g, int pk, int dx, long long dy, bool below,
                                              const KeyArgs& k, bool& valid) {
  const int tx = (pk & 1023) + dx;
  const long long ty = ((pk >> 10) & 1023) + dy;
  valid = below;
  if (kCull && valid) {
    valid = ellipse_keep(static_cast<float>(tx), __ll2float_rn(ty), k.tile_w, k.tile_h,
                         reinterpret_cast<const float2*>(k.cull) + 3 * static_cast<size_t>(g));
  }
  const unsigned long long tile = static_cast<unsigned long long>(ty * k.tiles_x + tx);
  return valid ? static_cast<long long>((tile << k.shift) | static_cast<unsigned long long>(g))
               : static_cast<long long>(INT64_MAX);
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
expand_keys_kernel(const int* __restrict__ offsets, const int* __restrict__ packed,
                   const float* __restrict__ cull, const int* __restrict__ num_valid, int n,
                   long long* __restrict__ keys, int* __restrict__ counts, int num_slots,
                   int num_tiles, int shift, int tiles_x, int tile_w, int tile_h) {
  __shared__ __align__(16) int mark[kTile];
  __shared__ __align__(16) int w[kWindow];
  __shared__ __align__(16) int wp[kWindow];
  __shared__ int wtot[kThreads / 32];
  __shared__ int plan[2];
  __shared__ int cnt[kTile / kChunk];
  if (threadIdx.x < kTile / kChunk) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int offl = __ldg(offsets + n - 1);
  const KeyArgs k{cull, __ldg(num_valid), shift, tiles_x, tile_w, tile_h};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int s0 = t * kTile, s1 = min(s0 + kTile, num_slots);
    int own[kVec * kRounds];
    const owner::Window win = owner::tile_owners<kThreads, kVec, kRounds, kWindow>(
        offsets, packed, n, offl, s0, s1, mark, wtot, plan, w, wp, own);
    // a rank's first slot and rect, from the window where it holds them
    auto rank_pk = [&](int g) {
      return g >= win.a0 && g <= win.hi ? wp[g - win.a0] : __ldg(packed + g);
    };
    auto rank_off = [&](int g) {
      return g >= win.a0 && g <= win.hi ? w[g - win.a0] : __ldg(offsets + g);
    };
    // num_slots is whole chunks, so a warp's run lies wholly below s1 or not
    const bool live = s0 + kWarpSlots * warp < s1;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (!live) break;
      const int i = s0 + owner::slot_of<kVec, kRounds>(warp, lane, r, 0);
      const int g = own[r * kVec], g1 = own[r * kVec + 1];
      const int pk = rank_pk(g);
      int dx;
      long long dy;
      slot_step(i, rank_off(g), pk, dx, dy);
      bool v0, v1;
      const long long k0 = slot_key<kCull>(g, pk, dx, dy, i < k.nv, k, v0);
      // slot i + 1: one step along g's rect, or the first slot of rank g1
      // (g1 > g owns i + 1 but not i, so offsets[g1] = i + 1)
      int dx1 = 0;
      long long dy1 = 0;
      if (g1 == g) {
        dx1 = dx + 1;
        dy1 = dy;
        if (dx1 == ((pk >> 20) & 1023)) {
          dx1 = 0;
          dy1 += 1;
        }
      }
      const long long k1 =
          slot_key<kCull>(g1, g1 == g ? pk : rank_pk(g1), dx1, dy1, i + 1 < k.nv, k, v1);
      *reinterpret_cast<longlong2*>(keys + i) = make_longlong2(k0, k1);
      const int c = __popc(__ballot_sync(0xffffffffu, v0)) + __popc(__ballot_sync(0xffffffffu, v1));
      if (lane == 0) atomicAdd(&cnt[kWarpSlots * warp / kChunk], c);
    }
    __syncthreads();
    if (threadIdx.x < kTile / kChunk) {
      if (s0 + kChunk * static_cast<int>(threadIdx.x) < s1)
        counts[s0 / kChunk + threadIdx.x] = cnt[threadIdx.x];
      cnt[threadIdx.x] = 0;
    }
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// offsets, packed (n,) int32 and cull (n, 6) f32 or null, in depth-rank
// order, each on 16 bytes; num_valid: one int32 on the device; keys
// (num_slots,) int64 and counts (num_slots / 1024,) int32 outputs, keys on
// 16 bytes; num_slots a multiple of 1024. Launches on `stream` and returns
// the first CUDA error of sizing the grid or of the launch.
int gags_expand_keys(const void* offsets, const void* packed, const void* cull,
                     const void* num_valid, int n, void* keys, void* counts,
                     int num_slots, int shift, int tiles_x, int tile_w, int tile_h,
                     void* stream) {
  if (num_slots <= 0) return 0;
  const int tiles = (num_slots + kTile - 1) / kTile;
  auto kernel = cull != nullptr ? expand_keys_kernel<true> : expand_keys_kernel<false>;
  int blocks = 0;
  const int err = owner::wave_blocks(kernel, kThreads, tiles, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(packed),
      static_cast<const float*>(cull), static_cast<const int*>(num_valid), n,
      static_cast<long long*>(keys), static_cast<int*>(counts), num_slots, tiles, shift,
      tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
