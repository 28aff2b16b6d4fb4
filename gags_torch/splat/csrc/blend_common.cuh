// blend_common.cuh: the per-(pixel, splat) arithmetic of every blend
// kernel (blend_forward.cu: K5 and K1; blend_backward.cu: K2;
// blend_backward_full.cu: K8).
//
// The backward recomputes the forward's walk, so both must take the same
// inclusion decisions at the 1/255 floor and the 1e-4 transmittance stop
// bit for bit, or a gradient appears or vanishes at a threshold. Every
// operation that feeds a decision is written with an explicit
// round-to-nearest intrinsic, so nvcc cannot contract it into a fused
// multiply-add differently in the two kernels. The association order is
// the plain PyTorch version's (kernels.blend_forward_plain):
//   sigma = 0.5 (ca dx dx + cc dy dy) + cb dx dy
//   alpha = min(0.999, opac exp(-sigma)); dropped if sigma < 0 or
//           alpha < 1/255
//   a splat with T (1 - alpha) < 1e-4 is not blended and ends the pixel;
//   otherwise w = alpha T and T becomes T (1 - alpha).

#pragma once

#include <cuda_runtime.h>

namespace gags {

constexpr float kAlphaFloor = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kTEps = 1e-4f;

// sigma of a splat at pixel centre (px, py), and the offsets dx, dy
__device__ __forceinline__ float splat_sigma(float px, float py, float mx, float my,
                                             float ca, float cb, float cc,
                                             float* dx_out, float* dy_out) {
  const float dx = __fsub_rn(px, mx);
  const float dy = __fsub_rn(py, my);
  *dx_out = dx;
  *dy_out = dy;
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// alpha of a splat of opacity op at a pixel where it has the given
// sigma; 0 where it does not count. Also returns vis = exp(-sigma), which
// the geometry gradient needs (left unset where sigma < 0).
__device__ __forceinline__ float alpha_of_sigma(float sigma, float op, float* vis_out) {
  if (sigma < 0.0f) return 0.0f;
  const float vis = expf(-sigma);
  *vis_out = vis;
  const float alpha = fminf(kAlphaClamp, __fmul_rn(op, vis));
  return alpha < kAlphaFloor ? 0.0f : alpha;
}

// alpha of a splat at pixel centre (px, py); 0 where it does not count
__device__ __forceinline__ float splat_alpha(float px, float py, float mx,
                                             float my, float ca, float cb,
                                             float cc, float op) {
  float dx, dy, vis;
  return alpha_of_sigma(splat_sigma(px, py, mx, my, ca, cb, cc, &dx, &dy), op, &vis);
}

// True where alpha_of_sigma(sigma, op) is surely 0 without its exp: for
// op <= 1, sigma > 5.55 gives op exp(-sigma) <= exp(-5.55) = 0.00389,
// 0.9% below the 1/255 floor, far beyond expf's and the product's
// rounding. The backward blends test it first: most walked pairs lie
// outside the splat's footprint.
constexpr float kFarSigma = 5.55f;

__device__ __forceinline__ bool surely_floored(float sigma, float op) {
  return sigma > kFarSigma && op <= 1.0f;
}

// The same test for a whole block of pixels at once: a box (x0, x1, y0,
// y1) in pixel coordinates such that alpha_of_sigma(splat_sigma(...)) is 0
// at every pixel centre outside it, for the geometry row g = [mx, my, ca,
// cb, cc, op]. With S = ln(255 op) + 0.01, a computed sigma above S gives
// op exp(-sigma) <= 0.99 / 255 (S <= 0: no pixel reaches the floor, the
// box is empty). The computed sigma is within gamma K sigma of the exact
// one (gamma = 1e-6 covers its ~5 roundings; K = 2 max(ca, cc) /
// lambda_min, here bounded above with lambda_max <= max(ca, cc) + |cb|,
// bounds the terms' absolute sum by K sigma), so every pixel outside the
// ellipse sigma <= S' = S (1 + 3 gamma K) computes a sigma above S. The
// box is that ellipse's bounding box, half-widths sqrt(2 S' cc / det) and
// sqrt(2 S' ca / det) (det by Kahan's fma form, accurate where it
// cancels), widened by 1e-5 of itself against this function's own float
// roundings and by a pixel against those of the offsets. Where the bound
// does not hold (op > 1 or NaN, a conic that is not positive definite,
// K > 1e5) the box is everything. Inline float intrinsics only: no
// subroutine call, so no spills around one.
__device__ __forceinline__ float4 floored_outside(const float* g) {
  const float kInf = __int_as_float(0x7f800000);
  const float4 all = make_float4(-kInf, kInf, -kInf, kInf);
  const float op = g[5];
  if (!(op <= 1.0f)) return all;
  const float s = op > 0.0f ? __fadd_rn(__logf(__fmul_rn(255.0f, op)), 0.01f) : -1.0f;
  if (s <= 0.0f) return make_float4(kInf, -kInf, kInf, -kInf);  // floored everywhere
  const float a = g[2], b = g[3], c = g[4];
  const float bb = __fmul_rn(b, b);
  const float det = __fadd_rn(__fmaf_rn(a, c, -bb), __fmaf_rn(-b, b, bb));
  if (!(a > 0.0f && c > 0.0f && det > 0.0f)) return all;
  const float m = fmaxf(a, c);
  const float k = __fdividef(2.0f * m * (m + fabsf(b)), det);
  constexpr float kGamma = 1e-6f;
  if (!(k <= 1e5f)) return all;
  const float s2 = __fdividef(2.0f * s * (1.0f + 3.0f * kGamma * k), det);
  const float qx = s2 * c, qy = s2 * a;  // NaN where they underflow: no skip
  const float hx = qx * rsqrtf(qx) * 1.00001f + 1.0f;
  const float hy = qy * rsqrtf(qy) * 1.00001f + 1.0f;
  return make_float4(g[0] - hx, g[0] + hx, g[1] - hy, g[1] + hy);
}

// transmittance after a splat of the given alpha
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// blend weight of an included splat
__device__ __forceinline__ float blend_weight(float T, float alpha) {
  return __fmul_rn(alpha, T);
}

// pixel centre of pixel p of tile `tile` (row-major tiles and pixels)
__device__ __forceinline__ void pixel_centre(int tile, int p, int tiles_x,
                                             int tile_h, int tile_w,
                                             float* px, float* py) {
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int row = p / tile_w;
  const int col = p - row * tile_w;
  *px = static_cast<float>(tx * tile_w + col) + 0.5f;
  *py = static_cast<float>(ty * tile_h + row) + 0.5f;
}

}  // namespace gags
