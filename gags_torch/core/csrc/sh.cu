// sh: J3, the 3DGS view-dependent colour of every Gaussian from its
// spherical-harmonics coefficients (core/sh.py `sh_colors`), degrees 0-4,
// and its vector-Jacobian product, one thread a Gaussian.
//
// Replaces no TPU kernel: the JAX package writes `sh_colors` as a chain of
// elementwise operations that XLA fuses. PyTorch runs the chain eagerly,
// ~300 launches forward and backward at degree 3, most of them strided
// passes over `sh.transpose(-1, -2)` and the select-backwards of its
// slices; on the RGB step that was the largest group of launches.
//
// Forward (gags_sh_forward): sh (N, K, 3) with the DC coefficient first,
// means (N, 3) and the camera centre (3,) on the device give the colours
// (N, 3): the view direction (means - campos) / (|means - campos| +
// 1e-12), the SH sum, + 0.5, clamped at 0. Each value equals the eager
// chain's on the card bit for bit: every operation is a round-to-nearest
// intrinsic in the chain's order (nvcc would otherwise contract a*b + c
// into an FMA), a Python scalar is its float32 rounding, and the norm's
// three squares are summed in the order of PyTorch's reduction kernel
// ((x^2 + z^2) + y^2: two threads share the three elements, the first
// holds x and z).
//
// Backward (gags_sh_backward): the colours' gradient gives the gradient of
// sh (N, K, 3), zero at every coefficient above (deg + 1)^2 as autograd
// gives it, and of the means through the normalised direction. The clamp's
// mask (colour >= 0, as clamp_min's backward takes it) comes from the
// float32 forward, recomputed here and not stored; the chain rule runs in
// float64 from the float32 inputs.
//
// What bounds it on the H100: bytes. At degree 3 with K = 16 a Gaussian
// reads 192 B of coefficients, 12 B of mean and writes 12 B forward;
// backward reads 216 B and writes 204 B. A thread's coefficients are one
// contiguous row, so a block stages its rows through shared memory with
// loads (and, backward, stores) that coalesce across the warp; a row's
// stride is odd so that a thread walking its own row meets no bank
// conflict.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

// the chain's Python constants, rounded to float32 as PyTorch rounds a
// scalar operand of a float32 tensor
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792;
constexpr double kC2_1 = -1.0925484305920792;
constexpr double kC2_2 = 0.31539156525252005;
constexpr double kC2_3 = -1.0925484305920792;
constexpr double kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435;
constexpr double kC3_1 = 2.890611442640554;
constexpr double kC3_2 = -0.4570457994644658;
constexpr double kC3_3 = 0.3731763325901154;
constexpr double kC3_4 = -0.4570457994644658;
constexpr double kC3_5 = 1.445305721320277;
constexpr double kC3_6 = -0.5900435899266435;
constexpr double kC4_0 = 2.5033429417967046;
constexpr double kC4_1 = -1.7701307697799304;
constexpr double kC4_2 = 0.9461746957575601;
constexpr double kC4_3 = -0.6690465435572892;
constexpr double kC4_4 = 0.10578554691520431;
constexpr double kC4_5 = -0.6690465435572892;
constexpr double kC4_6 = 0.47308734787878004;
constexpr double kC4_7 = -1.7701307697799304;
constexpr double kC4_8 = 0.6258357354491761;

__device__ __forceinline__ float f(double c) { return static_cast<float>(c); }

// Coefficients a thread's row holds: (DEG + 1)^2 x 3 floats, padded to an
// odd stride in shared memory.
template <int DEG>
struct Row {
  static constexpr int kCoeffs = (DEG + 1) * (DEG + 1);
  static constexpr int kFloats = 3 * kCoeffs;
  static constexpr int kStride = kFloats | 1;
};

// The view direction in float32, as the chain computes it.
__device__ __forceinline__ void direction_f32(const float* __restrict__ means,
                                              const float* __restrict__ campos, int64_t i,
                                              float d[3]) {
  float v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = fs(means[3 * i + j], __ldg(campos + j));
  const float nrm = __fsqrt_rn(fa(fa(fm(v[0], v[0]), fm(v[2], v[2])), fm(v[1], v[1])));
  const float den = fa(nrm, 1e-12f);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = __fdiv_rn(v[j], den);
}

// core/sh.py eval_sh for one channel (s: the row, stride 3), + 0.5, before
// the clamp; each line is one eager operation.
template <int DEG>
__device__ __forceinline__ float colour_f32(const float* s, float x, float y, float z) {
  float r = fm(f(kC0), s[0]);
  if (DEG > 0) {
    r = fs(fa(fs(r, fm(fm(f(kC1), y), s[3])), fm(fm(f(kC1), z), s[6])), fm(fm(f(kC1), x), s[9]));
  }
  if (DEG > 1) {
    const float xx = fm(x, x), yy = fm(y, y), zz = fm(z, z);
    const float xy = fm(x, y), yz = fm(y, z), xz = fm(x, z);
    r = fa(r, fm(fm(f(kC2_0), xy), s[12]));
    r = fa(r, fm(fm(f(kC2_1), yz), s[15]));
    r = fa(r, fm(fm(f(kC2_2), fs(fs(fm(2.0f, zz), xx), yy)), s[18]));
    r = fa(r, fm(fm(f(kC2_3), xz), s[21]));
    r = fa(r, fm(fm(f(kC2_4), fs(xx, yy)), s[24]));
    if (DEG > 2) {
      r = fa(r, fm(fm(fm(f(kC3_0), y), fs(fm(3.0f, xx), yy)), s[27]));
      r = fa(r, fm(fm(fm(f(kC3_1), xy), z), s[30]));
      r = fa(r, fm(fm(fm(f(kC3_2), y), fs(fs(fm(4.0f, zz), xx), yy)), s[33]));
      r = fa(r, fm(fm(fm(f(kC3_3), z), fs(fs(fm(2.0f, zz), fm(3.0f, xx)), fm(3.0f, yy))), s[36]));
      r = fa(r, fm(fm(fm(f(kC3_4), x), fs(fs(fm(4.0f, zz), xx), yy)), s[39]));
      r = fa(r, fm(fm(fm(f(kC3_5), z), fs(xx, yy)), s[42]));
      r = fa(r, fm(fm(fm(f(kC3_6), x), fs(xx, fm(3.0f, yy))), s[45]));
    }
    if (DEG > 3) {
      const float zz7m1 = fs(fm(7.0f, zz), 1.0f), zz7m3 = fs(fm(7.0f, zz), 3.0f);
      r = fa(r, fm(fm(fm(f(kC4_0), xy), fs(xx, yy)), s[48]));
      r = fa(r, fm(fm(fm(f(kC4_1), yz), fs(fm(3.0f, xx), yy)), s[51]));
      r = fa(r, fm(fm(fm(f(kC4_2), xy), zz7m1), s[54]));
      r = fa(r, fm(fm(fm(f(kC4_3), yz), zz7m3), s[57]));
      r = fa(r, fm(fm(f(kC4_4), fa(fm(zz, fs(fm(35.0f, zz), 30.0f)), 3.0f)), s[60]));
      r = fa(r, fm(fm(fm(f(kC4_5), xz), zz7m3), s[63]));
      r = fa(r, fm(fm(fm(f(kC4_6), fs(xx, yy)), zz7m1), s[66]));
      r = fa(r, fm(fm(fm(f(kC4_7), xz), fs(xx, fm(3.0f, yy))), s[69]));
      r = fa(r, fm(fm(f(kC4_8), fs(fm(xx, fs(xx, fm(3.0f, yy))), fm(yy, fs(fm(3.0f, xx), yy)))),
                   s[72]));
    }
  }
  return fa(r, 0.5f);
}

// Stage rows [i0, i0 + rows) of sh's first (DEG + 1)^2 coefficients in
// shared memory, the loads coalesced across the block.
template <int DEG>
__device__ __forceinline__ void stage_rows(const float* __restrict__ sh, int k, int64_t i0,
                                           int rows, float* smem) {
  using R = Row<DEG>;
  for (int e = threadIdx.x; e < rows * R::kFloats; e += kThreads) {
    const int r = e / R::kFloats, c = e - r * R::kFloats;
    smem[r * R::kStride + c] = sh[(i0 + r) * 3 * k + c];
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
    sh_forward_kernel(const float* __restrict__ sh, const float* __restrict__ means,
                      const float* __restrict__ campos, int n, int k,
                      float* __restrict__ colors) {
  using R = Row<DEG>;
  __shared__ float smem[kThreads * R::kStride];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = min(kThreads, static_cast<int>(n - i0));
  stage_rows<DEG>(sh, k, i0, rows, smem);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const int64_t i = i0 + threadIdx.x;
  float d[3];
  direction_f32(means, campos, i, d);
  const float* s = smem + threadIdx.x * R::kStride;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = colour_f32<DEG>(s + c, d[0], d[1], d[2]);
    colors[3 * i + c] = v != v ? v : fmaxf(v, 0.0f);  // clamp_min: NaN passes
  }
}

// One basis function's share of the backward: the coefficients' gradient
// written over the row in place, and the direction's gradient summed.
struct Vjp {
  double w[3];      // the colours' gradient where the clamp passed it, else 0
  double gd[3];     // dL/d(direction)
  float* row;       // the thread's staged row: coefficients in, gradients out
  __device__ __forceinline__ void term(int kk, double b, double bx, double by, double bz) {
    double ws = 0.0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double s = row[3 * kk + c];
      row[3 * kk + c] = static_cast<float>(w[c] * b);
      ws += w[c] * s;
    }
    gd[0] += ws * bx;
    gd[1] += ws * by;
    gd[2] += ws * bz;
  }
};

// Every basis function up to DEG with its gradient in (x, y, z), the
// closed forms of core/sh.py's polynomials.
template <int DEG>
__device__ __forceinline__ void basis_vjp(Vjp& v, double x, double y, double z) {
  v.term(0, kC0, 0.0, 0.0, 0.0);
  if (DEG > 0) {
    v.term(1, -kC1 * y, 0.0, -kC1, 0.0);
    v.term(2, kC1 * z, 0.0, 0.0, kC1);
    v.term(3, -kC1 * x, -kC1, 0.0, 0.0);
  }
  if (DEG > 1) {
    const double xx = x * x, yy = y * y, zz = z * z;
    v.term(4, kC2_0 * x * y, kC2_0 * y, kC2_0 * x, 0.0);
    v.term(5, kC2_1 * y * z, 0.0, kC2_1 * z, kC2_1 * y);
    v.term(6, kC2_2 * (2.0 * zz - xx - yy), -2.0 * kC2_2 * x, -2.0 * kC2_2 * y,
           4.0 * kC2_2 * z);
    v.term(7, kC2_3 * x * z, kC2_3 * z, 0.0, kC2_3 * x);
    v.term(8, kC2_4 * (xx - yy), 2.0 * kC2_4 * x, -2.0 * kC2_4 * y, 0.0);
    if (DEG > 2) {
      v.term(9, kC3_0 * y * (3.0 * xx - yy), kC3_0 * 6.0 * x * y, kC3_0 * 3.0 * (xx - yy),
             0.0);
      v.term(10, kC3_1 * x * y * z, kC3_1 * y * z, kC3_1 * x * z, kC3_1 * x * y);
      v.term(11, kC3_2 * y * (4.0 * zz - xx - yy), kC3_2 * -2.0 * x * y,
             kC3_2 * (4.0 * zz - xx - 3.0 * yy), kC3_2 * 8.0 * y * z);
      v.term(12, kC3_3 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), kC3_3 * -6.0 * x * z,
             kC3_3 * -6.0 * y * z, kC3_3 * (6.0 * zz - 3.0 * xx - 3.0 * yy));
      v.term(13, kC3_4 * x * (4.0 * zz - xx - yy), kC3_4 * (4.0 * zz - 3.0 * xx - yy),
             kC3_4 * -2.0 * x * y, kC3_4 * 8.0 * x * z);
      v.term(14, kC3_5 * z * (xx - yy), kC3_5 * 2.0 * x * z, kC3_5 * -2.0 * y * z,
             kC3_5 * (xx - yy));
      v.term(15, kC3_6 * x * (xx - 3.0 * yy), kC3_6 * 3.0 * (xx - yy), kC3_6 * -6.0 * x * y,
             0.0);
    }
    if (DEG > 3) {
      const double a1 = 7.0 * zz - 1.0, a3 = 7.0 * zz - 3.0;
      v.term(16, kC4_0 * x * y * (xx - yy), kC4_0 * y * (3.0 * xx - yy),
             kC4_0 * x * (xx - 3.0 * yy), 0.0);
      v.term(17, kC4_1 * y * z * (3.0 * xx - yy), kC4_1 * 6.0 * x * y * z,
             kC4_1 * 3.0 * z * (xx - yy), kC4_1 * y * (3.0 * xx - yy));
      v.term(18, kC4_2 * x * y * a1, kC4_2 * y * a1, kC4_2 * x * a1, kC4_2 * 14.0 * x * y * z);
      v.term(19, kC4_3 * y * z * a3, 0.0, kC4_3 * z * a3, kC4_3 * y * (21.0 * zz - 3.0));
      v.term(20, kC4_4 * (zz * (35.0 * zz - 30.0) + 3.0), 0.0, 0.0,
             kC4_4 * z * (140.0 * zz - 60.0));
      v.term(21, kC4_5 * x * z * a3, kC4_5 * z * a3, 0.0, kC4_5 * x * (21.0 * zz - 3.0));
      v.term(22, kC4_6 * (xx - yy) * a1, kC4_6 * 2.0 * x * a1, kC4_6 * -2.0 * y * a1,
             kC4_6 * 14.0 * z * (xx - yy));
      v.term(23, kC4_7 * x * z * (xx - 3.0 * yy), kC4_7 * 3.0 * z * (xx - yy),
             kC4_7 * -6.0 * x * y * z, kC4_7 * x * (xx - 3.0 * yy));
      v.term(24, kC4_8 * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
             kC4_8 * 4.0 * x * (xx - 3.0 * yy), kC4_8 * 4.0 * y * (yy - 3.0 * xx), 0.0);
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
    sh_backward_kernel(const float* __restrict__ sh, const float* __restrict__ means,
                       const float* __restrict__ campos, const float* __restrict__ g_colors,
                       int n, int k, float* __restrict__ g_sh, float* __restrict__ g_means) {
  using R = Row<DEG>;
  __shared__ float smem[kThreads * R::kStride];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = min(kThreads, static_cast<int>(n - i0));
  stage_rows<DEG>(sh, k, i0, rows, smem);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) {
    const int64_t i = i0 + threadIdx.x;
    float* row = smem + threadIdx.x * R::kStride;
    float d32[3];
    direction_f32(means, campos, i, d32);
    Vjp v;
    v.row = row;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float col = colour_f32<DEG>(row + c, d32[0], d32[1], d32[2]);
      v.w[c] = col >= 0.0f ? static_cast<double>(g_colors[3 * i + c]) : 0.0;
      v.gd[c] = 0.0;
    }
    double dv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dv[j] = static_cast<double>(means[3 * i + j]) - static_cast<double>(__ldg(campos + j));
    }
    const double r = sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]);
    const double den = r + 1e-12;
    basis_vjp<DEG>(v, dv[0] / den, dv[1] / den, dv[2] / den);
    // direction = dv / (r + eps): d(direction)/d(dv) = I / den - dv dv^T / (den^2 r),
    // the second term 0 at r = 0 as the norm's backward takes it
    const double dot = v.gd[0] * dv[0] + v.gd[1] * dv[1] + v.gd[2] * dv[2];
    const double k2 = r > 0.0 ? dot / (den * den * r) : 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_means[3 * i + j] = static_cast<float>(v.gd[j] / den - dv[j] * k2);
    }
  }
  __syncthreads();
  // the coefficients' gradient, with zeros above (DEG + 1)^2, coalesced
  const int width = 3 * k;
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    g_sh[i0 * width + e] = c < R::kFloats ? smem[r * R::kStride + c] : 0.0f;
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sh (n, k, 3), means (n, 3), campos (3,) -> colors (n, 3); deg 0-4, k >= (deg + 1)^2.
int gags_sh_forward(const float* sh, const float* means, const float* campos, int n, int k,
                    int deg, float* colors, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: sh_forward_kernel<0><<<blocks, kThreads, 0, s>>>(sh, means, campos, n, k, colors); break;
    case 1: sh_forward_kernel<1><<<blocks, kThreads, 0, s>>>(sh, means, campos, n, k, colors); break;
    case 2: sh_forward_kernel<2><<<blocks, kThreads, 0, s>>>(sh, means, campos, n, k, colors); break;
    case 3: sh_forward_kernel<3><<<blocks, kThreads, 0, s>>>(sh, means, campos, n, k, colors); break;
    case 4: sh_forward_kernel<4><<<blocks, kThreads, 0, s>>>(sh, means, campos, n, k, colors); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The VJP: g_colors (n, 3) -> g_sh (n, k, 3), g_means (n, 3).
int gags_sh_backward(const float* sh, const float* means, const float* campos,
                     const float* g_colors, int n, int k, int deg, float* g_sh, float* g_means,
                     void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GAGS_SH_BACKWARD(D)                                                          \
  sh_backward_kernel<D><<<blocks, kThreads, 0, s>>>(sh, means, campos, g_colors, n, k, \
                                                    g_sh, g_means)
  switch (deg) {
    case 0: GAGS_SH_BACKWARD(0); break;
    case 1: GAGS_SH_BACKWARD(1); break;
    case 2: GAGS_SH_BACKWARD(2); break;
    case 3: GAGS_SH_BACKWARD(3); break;
    case 4: GAGS_SH_BACKWARD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GAGS_SH_BACKWARD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
