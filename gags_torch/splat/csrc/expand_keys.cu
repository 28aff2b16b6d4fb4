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
//   slot   = i - offsets[g];  dy = slot / pw;  dx = slot - dy * pw
//   tile   = (y0 + dy) * tiles_x + (x0 + dx)   with (x0, y0, pw) unpacked
//            from packed[g] = x0 | y0 << 10 | max(w, 1) << 20
//   valid  = i < num_valid  and  (no cull  or  ellipse_keep(tile, cull[g]))
//   key    = valid ? (tile << shift) | g : INT64_MAX
//
// plus the valid count of every 1024-slot chunk. The port sorts int64
// keys, so the JAX package's int32 / uint32 tiers are one case here with
// the same order; INT64_MAX fillers sort after every real key.
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
// What bounds it on the H100: bytes. Each slot writes one int64 key; each
// rank's offset, packed rect and (with the cull) 6 cull floats are read
// through the L2, which holds the whole per-rank table of a 1M-Gaussian
// scene (32 MB with the cull). The owner search reads ~log2(n) offsets
// per slot, all L2 hits.
//
// Design (simple first): one thread per slot, one block of 1024 threads
// per 1024-slot chunk, whose valid count is __syncthreads_count. The owner
// is an upper-bound binary search over the exclusive per-rank offsets, as
// K6 does (expand_gid.cu); the TPU kernel's scalar-prefetched owner
// windows, one-hot matmul gathers and f32-exact integer arithmetic exist
// for Mosaic and are not needed: the rect arithmetic is integer here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;

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

// tiles.ellipse_tile_keep for one (tile, cull row [mx, my, a, b, c, L])
__device__ __forceinline__ bool ellipse_keep(int tx, int ty, int tile_w,
                                             int tile_h, const float* row) {
  const float mx = row[0], my = row[1], a = row[2], b = row[3], c = row[4],
              lvl = row[5];
  const float u0 = __fsub_rn(
      __fadd_rn(__fmul_rn(static_cast<float>(tx), static_cast<float>(tile_w)), 0.5f), mx);
  const float u1 = __fadd_rn(u0, static_cast<float>(tile_w - 1));
  const float v0 = __fsub_rn(
      __fadd_rn(__fmul_rn(static_cast<float>(ty), static_cast<float>(tile_h)), 0.5f), my);
  const float v1 = __fadd_rn(v0, static_cast<float>(tile_h - 1));
  const bool inside = (u0 <= 0.0f) && (0.0f <= u1) && (v0 <= 0.0f) && (0.0f <= v1);
  // edges u = u0, u1 minimise over v; edges v = v0, v1 over u (a and c swap)
  const float smin = min_nan(min_nan(edge_min(u0, v0, v1, a, b, c),
                                     edge_min(u1, v0, v1, a, b, c)),
                             min_nan(edge_min(v0, u0, u1, c, b, a),
                                     edge_min(v1, u0, u1, c, b, a)));
  return inside || (smin <= lvl);
}

__global__ void __launch_bounds__(kChunk)
expand_keys_kernel(const int* __restrict__ offsets, const int* __restrict__ packed,
                   const float* __restrict__ cull, const int* __restrict__ num_valid,
                   int n, long long* __restrict__ keys, int* __restrict__ counts,
                   int num_slots, int shift, int tiles_x, int tile_w, int tile_h) {
  const int i = blockIdx.x * kChunk + threadIdx.x;
  bool valid = false;
  if (i < num_slots) {
    // upper bound: first j with offsets[j] > i
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int g = lo - 1;
    g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
    const int pk = __ldg(packed + g);
    const int x0 = pk & 1023;
    const int y0 = (pk >> 10) & 1023;
    const int pw = (pk >> 20) & 1023;
    const int slot = i - __ldg(offsets + g);
    const int dy = slot / pw;
    const int tx = x0 + (slot - dy * pw);
    const int ty = y0 + dy;
    valid = i < __ldg(num_valid);
    if (valid && cull != nullptr) {
      valid = ellipse_keep(tx, ty, tile_w, tile_h, cull + static_cast<size_t>(g) * 6);
    }
    keys[i] = valid ? ((static_cast<long long>(ty) * tiles_x + tx) << shift) | g
                    : static_cast<long long>(INT64_MAX);
  }
  const int cnt = __syncthreads_count(valid);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// offsets, packed (n,) int32 and cull (n, 6) f32 or null, in depth-rank
// order; num_valid: one int32 on the device; keys (num_slots,) int64 and
// counts (ceil(num_slots / 1024),) int32 outputs. Launches on `stream` and
// returns cudaGetLastError() of the launch.
int gags_expand_keys(const void* offsets, const void* packed, const void* cull,
                     const void* num_valid, int n, void* keys, void* counts,
                     int num_slots, int shift, int tiles_x, int tile_w, int tile_h,
                     void* stream) {
  if (num_slots <= 0) return 0;
  const int blocks = (num_slots + kChunk - 1) / kChunk;
  expand_keys_kernel<<<blocks, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(packed),
      static_cast<const float*>(cull), static_cast<const int*>(num_valid), n,
      static_cast<long long*>(keys), static_cast<int*>(counts), num_slots, shift,
      tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
