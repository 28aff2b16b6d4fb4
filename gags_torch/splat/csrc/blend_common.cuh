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

// alpha of a splat at pixel centre (px, py); 0 where it does not count.
// Also returns the offsets dx, dy and vis = exp(-sigma), which the
// geometry gradient needs (vis is left unset where sigma < 0).
__device__ __forceinline__ float splat_alpha_parts(float px, float py,
                                                   float mx, float my,
                                                   float ca, float cb,
                                                   float cc, float op,
                                                   float* dx_out,
                                                   float* dy_out,
                                                   float* vis_out) {
  const float dx = __fsub_rn(px, mx);
  const float dy = __fsub_rn(py, my);
  *dx_out = dx;
  *dy_out = dy;
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float sigma =
      __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
  if (sigma < 0.0f) return 0.0f;
  const float vis = expf(-sigma);
  *vis_out = vis;
  const float alpha = fminf(kAlphaClamp, __fmul_rn(op, vis));
  return alpha < kAlphaFloor ? 0.0f : alpha;
}

__device__ __forceinline__ float splat_alpha(float px, float py, float mx,
                                             float my, float ca, float cb,
                                             float cc, float op) {
  float dx, dy, vis;
  return splat_alpha_parts(px, py, mx, my, ca, cb, cc, op, &dx, &dy, &vis);
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
