// project: J2, the per-Gaussian EWA projection (splat/projection.py) and
// its vector-Jacobian product, one thread a Gaussian.
//
// Replaces no TPU kernel: the JAX package writes the projection as a chain
// of elementwise operations that XLA fuses into a few loops. PyTorch runs
// the same chain eagerly, ~290 launches forward and ~440 in autograd's
// backward, each a pass over N floats built from 0-dim slices of the
// camera. On the RGB step that was ~1,000 of its ~1,800 launches.
//
// Forward (gags_project_forward): means (N, 3), quats (N, 4) wxyz, scales
// (N, 3) activated, the (4, 4) view matrix and (3, 3) intrinsics on the
// device (read by every thread, so no host copy syncs the stream) give
// means2d, conics, depths, radii, compensations, radii_x, radii_y and,
// given opacities, the (N + 1, 8) geometry table [mx, my, conic a, b, c,
// opacity x compensation, 0, 0] with its zero sentinel row (the means2d
// tap, a zero tensor whose gradient is the densification signal, added to
// mx, my); or the table alone, for a caller that bins nothing. Every
// value equals the plain chain's on the card bit for bit, so binnings and
// radii do not move: each operation is written with a round-to-nearest
// intrinsic in the plain chain's order (nvcc would otherwise contract
// a*b + c into an FMA), a scalar divisor is a reciprocal then a product as
// `x / tensor` is in PyTorch, and the clips and clamps propagate NaN as
// torch.maximum / torch.clamp_min do.
//
// Backward (gags_project_backward): the geometry table's gradient (the
// means2d columns carry the tap's, which the wrapper slices) gives the
// gradients of means, quats, scales and opacities. The intermediates are
// recomputed from the inputs instead of being saved, and the chain rule
// runs in float64, as autograd's would through the plain chain. Its masks
// (the depth select, the determinant select, the FoV clip with a half
// gradient at a tie, the clamps) come from the forward's float32 chain,
// recomputed, so a row at a threshold takes the branch that made its
// table row. A row whose six upstream values
// are zero (a culled or parked Gaussian) gets exact zeros and never a
// NaN. Where the antialiasing compensation is 0 its square root's
// gradient, infinite in autograd, is taken as 0.
//
// What bounds it on the H100: bytes. Forward, 44 B read and 40 B written
// a Gaussian (72 with the table, 32 with the table alone); backward, 76 B
// read and 44 B written. Neither reuses data across threads, so a thread a
// Gaussian with scalar loads that coalesce across the warp is the design;
// the backward's arithmetic (~570 float64 operations a Gaussian and the
// ~250 of the float32 chain) stays near the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsq(float a) { return __fsqrt_rn(a); }
// `x / t` with a tensor divisor t is t.reciprocal() * x in PyTorch
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.maximum / torch.minimum: the first NaN operand, else max / min
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp_min / torch.clamp_max with a scalar bound: NaN passes
__device__ __forceinline__ float clamp_lo(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_hi(float v, float hi) { return v != v ? v : fminf(v, hi); }

struct Cam {
  float r[9], t[3], fx, fy, cx, cy;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ vm, const float* __restrict__ K) {
  Cam c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.r[3 * i + j] = __ldg(vm + 4 * i + j);
    c.t[i] = __ldg(vm + 4 * i + 3);
  }
  c.fx = __ldg(K + 0);
  c.cx = __ldg(K + 2);
  c.fy = __ldg(K + 4);
  c.cy = __ldg(K + 5);
  return c;
}

// The forward's float32 chain up to the conic, in the plain chain's order;
// the backward recomputes it for the branches the forward took.
struct Fwd32 {
  float px, py, z, zs, rz, ux, uy, lim_x, lim_y, a_b, c_b, b, det, comp, conic_a, conic_b,
      conic_c;
  bool in_depth, valid_det;
};

__device__ __forceinline__ Fwd32 fwd32(const Cam& cam, const float* __restrict__ means,
                                       const float* __restrict__ quats,
                                       const float* __restrict__ scales, int i, int width,
                                       int height, float eps2d, float near_plane,
                                       float far_plane, int antialiased) {
  Fwd32 f;
  const float* R = cam.r;
  const float w0 = means[3 * i], w1 = means[3 * i + 1], w2 = means[3 * i + 2];

  // world -> camera
  f.px = fa(fa(fa(fm(R[0], w0), fm(R[1], w1)), fm(R[2], w2)), cam.t[0]);
  f.py = fa(fa(fa(fm(R[3], w0), fm(R[4], w1)), fm(R[5], w2)), cam.t[1]);
  f.z = fa(fa(fa(fm(R[6], w0), fm(R[7], w1)), fm(R[8], w2)), cam.t[2]);
  f.in_depth = (f.z > near_plane) && (f.z < far_plane);
  f.zs = f.in_depth ? f.z : 1.0f;

  // camera-frame covariance (R L)(R L)^T, L = R_quat diag(s)
  const float q0 = quats[4 * i], q1 = quats[4 * i + 1], q2 = quats[4 * i + 2],
              q3 = quats[4 * i + 3];
  const float s0 = scales[3 * i], s1 = scales[3 * i + 1], s2 = scales[3 * i + 2];
  const float qden =
      fsq(fa(fa(fa(fa(fm(q0, q0), fm(q1, q1)), fm(q2, q2)), fm(q3, q3)), 1e-24f));
  const float qw = fd(q0, qden), qx = fd(q1, qden), qy = fd(q2, qden), qz = fd(q3, qden);
  float L[9];
  L[0] = fm(fs(1.0f, fm(2.0f, fa(fm(qy, qy), fm(qz, qz)))), s0);
  L[1] = fm(fm(2.0f, fs(fm(qx, qy), fm(qw, qz))), s1);
  L[2] = fm(fm(2.0f, fa(fm(qx, qz), fm(qw, qy))), s2);
  L[3] = fm(fm(2.0f, fa(fm(qx, qy), fm(qw, qz))), s0);
  L[4] = fm(fs(1.0f, fm(2.0f, fa(fm(qx, qx), fm(qz, qz)))), s1);
  L[5] = fm(fm(2.0f, fs(fm(qy, qz), fm(qw, qx))), s2);
  L[6] = fm(fm(2.0f, fs(fm(qx, qz), fm(qw, qy))), s0);
  L[7] = fm(fm(2.0f, fa(fm(qy, qz), fm(qw, qx))), s1);
  L[8] = fm(fs(1.0f, fm(2.0f, fa(fm(qx, qx), fm(qy, qy)))), s2);
  float M[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      M[3 * r + c] = fa(fa(fm(R[3 * r], L[c]), fm(R[3 * r + 1], L[3 + c])),
                        fm(R[3 * r + 2], L[6 + c]));
    }
  }
  auto dot = [&](int a, int b) {
    return fa(fa(fm(M[3 * a], M[3 * b]), fm(M[3 * a + 1], M[3 * b + 1])),
              fm(M[3 * a + 2], M[3 * b + 2]));
  };
  const float c00 = dot(0, 0), c01 = dot(0, 1), c02 = dot(0, 2);
  const float c11 = dot(1, 1), c12 = dot(1, 2), c22 = dot(2, 2);

  // perspective Jacobian with the FoV clamp
  f.lim_x = fm(fm(rcp(cam.fx), 0.5f * static_cast<float>(width)), 1.3f);
  f.lim_y = fm(fm(rcp(cam.fy), 0.5f * static_cast<float>(height)), 1.3f);
  f.ux = fd(f.px, f.zs);
  f.uy = fd(f.py, f.zs);
  const float tx = fm(f.zs, tmin(tmax(f.ux, -f.lim_x), f.lim_x));
  const float ty = fm(f.zs, tmin(tmax(f.uy, -f.lim_y), f.lim_y));
  f.rz = rcp(f.zs);
  const float rz = f.rz;
  const float rz2 = fm(rz, rz);
  const float j00 = fm(cam.fx, rz);
  const float j02 = fm(fm(-cam.fx, tx), rz2);
  const float j11 = fm(cam.fy, rz);
  const float j12 = fm(fm(-cam.fy, ty), rz2);

  // cov2d = J cov_cam J^T
  const float a =
      fa(fm(j00, fa(fm(j00, c00), fm(j02, c02))), fm(j02, fa(fm(j00, c02), fm(j02, c22))));
  f.b = fa(fm(j00, fa(fm(j11, c01), fm(j12, c02))), fm(j02, fa(fm(j11, c12), fm(j12, c22))));
  const float c =
      fa(fm(j11, fa(fm(j11, c11), fm(j12, c12))), fm(j12, fa(fm(j11, c12), fm(j12, c22))));

  const float det_orig = fs(fm(a, c), fm(f.b, f.b));
  f.a_b = fa(a, eps2d);
  f.c_b = fa(c, eps2d);
  f.det = fs(fm(f.a_b, f.c_b), fm(f.b, f.b));
  f.comp = antialiased ? fsq(clamp_lo(fd(det_orig, clamp_lo(f.det, 1e-30f)), 0.0f)) : 1.0f;

  f.valid_det = f.det > 0.0f;
  const float inv_det = rcp(f.valid_det ? f.det : 1.0f);
  f.conic_a = fm(f.c_b, inv_det);
  f.conic_b = fm(-f.b, inv_det);
  f.conic_c = fm(f.a_b, inv_det);
  return f;
}

struct FwdArgs {
  const float *means, *quats, *scales, *opacities, *tap, *vm, *K;
  int n, width, height, extents, antialiased;
  float eps2d, near_plane, far_plane;
  float *means2d, *conics, *depths, *comps, *table;  // means2d null: the table alone
  int *radii, *radii_x, *radii_y;
};

__global__ void __launch_bounds__(kThreads) project_forward_kernel(FwdArgs p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > p.n) return;
  if (i == p.n) {  // the table's sentinel row
    if (p.table != nullptr) {
      float4* row = reinterpret_cast<float4*>(p.table + 8 * static_cast<int64_t>(i));
      row[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      row[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const Cam cam = load_cam(p.vm, p.K);
  const Fwd32 f = fwd32(cam, p.means, p.quats, p.scales, i, p.width, p.height, p.eps2d,
                        p.near_plane, p.far_plane, p.antialiased);
  const float mx = fa(fm(fm(cam.fx, f.px), f.rz), cam.cx);
  const float my = fa(fm(fm(cam.fy, f.py), f.rz), cam.cy);
  const float opac = p.opacities != nullptr ? p.opacities[i] : 0.0f;

  if (p.means2d != nullptr) {
    // extents
    const float bmid = fm(0.5f, fa(f.a_b, f.c_b));
    const float v1 = fa(bmid, fsq(clamp_lo(fs(fm(bmid, bmid), f.det), 0.01f)));
    const float radius = ceilf(fm(3.0f, fsq(v1)));
    float k = 3.0f;
    if (p.extents) {
      const float o_eff = fm(opac, f.comp);
      k = clamp_hi(fsq(fm(2.0f, clamp_lo(logf(fm(255.0f, clamp_lo(o_eff, 1e-12f))), 0.0f))),
                   3.0f);
    }
    const float sx = fsq(clamp_lo(f.a_b, 0.0f));
    const float sy = fsq(clamp_lo(f.c_b, 0.0f));
    const float rx = ceilf(fm(k, sx));
    const float ry = ceilf(fm(k, sy));

    // border cull on the geometric 3-sigma box
    const float rx3 = ceilf(fm(3.0f, sx));
    const float ry3 = ceilf(fm(3.0f, sy));
    const bool inside = (fa(mx, rx3) > 0.0f) && (fs(mx, rx3) < static_cast<float>(p.width)) &&
                        (fa(my, ry3) > 0.0f) && (fs(my, ry3) < static_cast<float>(p.height));
    const bool valid = f.in_depth && f.valid_det && (radius > 0.0f) && inside;

    p.means2d[2 * i] = mx;
    p.means2d[2 * i + 1] = my;
    p.conics[3 * i] = f.conic_a;
    p.conics[3 * i + 1] = f.conic_b;
    p.conics[3 * i + 2] = f.conic_c;
    p.depths[i] = f.z;
    p.comps[i] = f.comp;
    p.radii[i] = valid ? static_cast<int>(radius) : 0;
    p.radii_x[i] = valid ? static_cast<int>(rx) : 0;
    p.radii_y[i] = valid ? static_cast<int>(ry) : 0;
  }
  if (p.table != nullptr) {
    float tmx = mx, tmy = my;
    if (p.tap != nullptr) {
      tmx = fa(mx, p.tap[2 * i]);
      tmy = fa(my, p.tap[2 * i + 1]);
    }
    float4* row = reinterpret_cast<float4*>(p.table + 8 * static_cast<int64_t>(i));
    row[0] = make_float4(tmx, tmy, f.conic_a, f.conic_b);
    row[1] = make_float4(f.conic_c, fm(opac, f.comp), 0.0f, 0.0f);
  }
}

// d min(max(x, lo), hi) / dx as autograd gives it: 1 inside, 0 outside, a
// half at each tie (torch.maximum's and torch.minimum's backward), decided
// on the forward's float32 values
__device__ __forceinline__ double clip_grad(float x, float lo, float hi) {
  const float m = tmax(x, lo);
  const double gm = m < hi ? 1.0 : (m == hi ? 0.5 : 0.0);
  return gm * (x > lo ? 1.0 : (x == lo ? 0.5 : 0.0));
}

struct BwdArgs {
  const float *means, *quats, *scales, *opacities, *vm, *K, *g_table;
  int n, width, height, antialiased;
  double eps2d, near_plane, far_plane;
  float *g_means, *g_quats, *g_scales, *g_opac;
};

__global__ void __launch_bounds__(kThreads) project_backward_kernel(BwdArgs p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const float4 ga4 = reinterpret_cast<const float4*>(p.g_table)[2 * static_cast<int64_t>(i)];
  const float2 gb2 = reinterpret_cast<const float2*>(p.g_table)[4 * static_cast<int64_t>(i) + 2];
  if (ga4.x == 0.f && ga4.y == 0.f && ga4.z == 0.f && ga4.w == 0.f && gb2.x == 0.f &&
      gb2.y == 0.f) {  // no upstream gradient: exact zeros, whatever the row holds
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p.g_means[3 * i + j] = 0.f;
      p.g_scales[3 * i + j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) p.g_quats[4 * i + j] = 0.f;
    p.g_opac[i] = 0.f;
    return;
  }
  const double g_mx = ga4.x, g_my = ga4.y, g_ca = ga4.z, g_cb = ga4.w, g_cc = gb2.x,
               g_op = gb2.y;
  // the branches (depth, FoV clip, determinant, clamps) as the forward took
  // them, in float32; the values below in float64
  const Fwd32 f = fwd32(load_cam(p.vm, p.K), p.means, p.quats, p.scales, i, p.width, p.height,
                        static_cast<float>(p.eps2d), static_cast<float>(p.near_plane),
                        static_cast<float>(p.far_plane), p.antialiased);

  double R[9], t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * r + c] = __ldg(p.vm + 4 * r + c);
    t[r] = __ldg(p.vm + 4 * r + 3);
  }
  const double fx = __ldg(p.K + 0), fy = __ldg(p.K + 4);
  const double w[3] = {p.means[3 * i], p.means[3 * i + 1], p.means[3 * i + 2]};
  const double q[4] = {p.quats[4 * i], p.quats[4 * i + 1], p.quats[4 * i + 2],
                       p.quats[4 * i + 3]};
  const double s[3] = {p.scales[3 * i], p.scales[3 * i + 1], p.scales[3 * i + 2]};
  const double o = p.opacities[i];

  // ---- the forward, recomputed ----
  const double px = R[0] * w[0] + R[1] * w[1] + R[2] * w[2] + t[0];
  const double py = R[3] * w[0] + R[4] * w[1] + R[5] * w[2] + t[1];
  const double z = R[6] * w[0] + R[7] * w[1] + R[8] * w[2] + t[2];
  const double zs = f.in_depth ? z : 1.0;

  const double qden = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-24);
  const double qw = q[0] / qden, qx = q[1] / qden, qy = q[2] / qden, qz = q[3] / qden;
  double Rq[9];
  Rq[0] = 1.0 - 2.0 * (qy * qy + qz * qz);
  Rq[1] = 2.0 * (qx * qy - qw * qz);
  Rq[2] = 2.0 * (qx * qz + qw * qy);
  Rq[3] = 2.0 * (qx * qy + qw * qz);
  Rq[4] = 1.0 - 2.0 * (qx * qx + qz * qz);
  Rq[5] = 2.0 * (qy * qz - qw * qx);
  Rq[6] = 2.0 * (qx * qz - qw * qy);
  Rq[7] = 2.0 * (qy * qz + qw * qx);
  Rq[8] = 1.0 - 2.0 * (qx * qx + qy * qy);
  double M[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      M[3 * r + c] =
          (R[3 * r] * Rq[c] + R[3 * r + 1] * Rq[3 + c] + R[3 * r + 2] * Rq[6 + c]) * s[c];
    }
  }
  auto dot = [&](int a, int b) {
    return M[3 * a] * M[3 * b] + M[3 * a + 1] * M[3 * b + 1] + M[3 * a + 2] * M[3 * b + 2];
  };
  const double c00 = dot(0, 0), c01 = dot(0, 1), c02 = dot(0, 2);
  const double c11 = dot(1, 1), c12 = dot(1, 2), c22 = dot(2, 2);

  const double lim_x = 1.3 * (0.5 * p.width / fx);
  const double lim_y = 1.3 * (0.5 * p.height / fy);
  const double ux = px / zs, uy = py / zs;
  const double gclx = clip_grad(f.ux, -f.lim_x, f.lim_x);
  const double gcly = clip_grad(f.uy, -f.lim_y, f.lim_y);
  // the clipped value: ux inside, the limit outside (either at a tie)
  const double clx = gclx > 0.0 ? ux : (f.ux < 0.0f ? -lim_x : lim_x);
  const double cly = gcly > 0.0 ? uy : (f.uy < 0.0f ? -lim_y : lim_y);
  const double tx = zs * clx, ty = zs * cly;
  const double rz = 1.0 / zs;
  const double rz2 = rz * rz;
  const double j00 = fx * rz, j02 = -fx * tx * rz2, j11 = fy * rz, j12 = -fy * ty * rz2;
  const double a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22);
  const double b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22);
  const double c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22);
  const double a_b = a + p.eps2d, c_b = c + p.eps2d;
  // a needle's covariance is rank one even in float64 and its determinant
  // may cancel to <= 0 where the forward's float32 one came out positive:
  // the float32 value stands in there, as in float32 autograd
  const double det64 = a_b * c_b - b * b;
  const double det = f.valid_det && !(det64 > 0.0) ? static_cast<double>(f.det) : det64;
  const double inv = 1.0 / (f.valid_det ? det : 1.0);

  // ---- the table's columns back to a, b, c ----
  double g_o = g_op, g_a = 0.0, g_b = 0.0, g_c = 0.0;
  const double g_inv = g_ca * c_b - g_cb * b + g_cc * a_b;
  double g_a_b = g_cc * inv, g_c_b = g_ca * inv;
  g_b -= g_cb * inv;
  double g_det = f.valid_det ? -g_inv * inv * inv : 0.0;
  if (p.antialiased) {  // opacity column o * sqrt(max(det_orig / max(det, 1e-30), 0))
    const double det_orig = a * c - b * b;
    const bool det_kept = f.det >= 1e-30f;  // clamp_min passes the gradient where x >= min
    const double dm = det_kept ? det : 1e-30;
    const double ratio = det_orig / dm;
    const double comp = f.comp > 0.0f ? sqrt(ratio > 0.0 ? ratio : 0.0) : 0.0;
    g_o = g_op * comp;
    const double g_ratio = comp > 0.0 ? g_op * o / (2.0 * comp) : 0.0;
    const double g_do = g_ratio / dm;
    if (det_kept) g_det -= g_ratio * det_orig / (dm * dm);
    g_a += g_do * c;
    g_c += g_do * a;
    g_b -= 2.0 * b * g_do;
  }
  g_a_b += g_det * c_b;
  g_c_b += g_det * a_b;
  g_b -= 2.0 * b * g_det;
  g_a += g_a_b;
  g_c += g_c_b;

  // ---- cov2d = J C J^T back to J and C ----
  const double g_j00 = g_a * (2.0 * j00 * c00 + 2.0 * j02 * c02) + g_b * (j11 * c01 + j12 * c02);
  const double g_j02 = g_a * (2.0 * j00 * c02 + 2.0 * j02 * c22) + g_b * (j11 * c12 + j12 * c22);
  const double g_j11 = g_b * (j00 * c01 + j02 * c12) + g_c * (2.0 * j11 * c11 + 2.0 * j12 * c12);
  const double g_j12 = g_b * (j00 * c02 + j02 * c22) + g_c * (2.0 * j11 * c12 + 2.0 * j12 * c22);
  const double g_c00 = g_a * j00 * j00;
  const double g_c01 = g_b * j00 * j11;
  const double g_c02 = g_a * 2.0 * j00 * j02 + g_b * j00 * j12;
  const double g_c11 = g_c * j11 * j11;
  const double g_c12 = g_b * j02 * j11 + g_c * 2.0 * j11 * j12;
  const double g_c22 = g_a * j02 * j02 + g_b * j02 * j12 + g_c * j12 * j12;

  // ---- J and the screen position back to the camera-frame point ----
  double g_rz = fx * g_j00 + fy * g_j11 + fx * px * g_mx + fy * py * g_my;
  const double g_rz2 = -fx * tx * g_j02 - fy * ty * g_j12;
  const double g_tx = -fx * rz2 * g_j02, g_ty = -fy * rz2 * g_j12;
  double g_px = fx * rz * g_mx, g_py = fy * rz * g_my;
  g_rz += 2.0 * rz * g_rz2;
  double g_zs = -rz * rz * g_rz + clx * g_tx + cly * g_ty;
  const double g_ux = zs * g_tx * gclx;
  const double g_uy = zs * g_ty * gcly;
  g_px += g_ux / zs;
  g_py += g_uy / zs;
  g_zs -= (g_ux * px + g_uy * py) / (zs * zs);
  const double g_z = f.in_depth ? g_zs : 0.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p.g_means[3 * i + j] = static_cast<float>(R[j] * g_px + R[3 + j] * g_py + R[6 + j] * g_z);
  }

  // ---- C = M M^T back to M, M = R L, L = R_quat diag(s) ----
  double gM[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gM[j] = 2.0 * g_c00 * M[j] + g_c01 * M[3 + j] + g_c02 * M[6 + j];
    gM[3 + j] = g_c01 * M[j] + 2.0 * g_c11 * M[3 + j] + g_c12 * M[6 + j];
    gM[6 + j] = g_c02 * M[j] + g_c12 * M[3 + j] + 2.0 * g_c22 * M[6 + j];
  }
  double G[9];  // the gradient of R_quat
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      G[3 * k + j] = R[k] * gM[j] + R[3 + k] * gM[3 + j] + R[6 + k] * gM[6 + j];  // gL
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p.g_scales[3 * i + j] =
        static_cast<float>(G[j] * Rq[j] + G[3 + j] * Rq[3 + j] + G[6 + j] * Rq[6 + j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) G[3 * k + j] *= s[j];
  }
  const double gw = 2.0 * (-qz * G[1] + qy * G[2] + qz * G[3] - qx * G[5] - qy * G[6] + qx * G[7]);
  const double gx = 2.0 * (qy * G[1] + qz * G[2] + qy * G[3] - 2.0 * qx * G[4] - qw * G[5] +
                           qz * G[6] + qw * G[7] - 2.0 * qx * G[8]);
  const double gy = 2.0 * (-2.0 * qy * G[0] + qx * G[1] + qw * G[2] + qx * G[3] + qz * G[5] -
                           qw * G[6] + qz * G[7] - 2.0 * qy * G[8]);
  const double gz = 2.0 * (-2.0 * qz * G[0] - qw * G[1] + qx * G[2] + qw * G[3] -
                           2.0 * qz * G[4] + qy * G[5] + qx * G[6] + qy * G[7]);
  // q / |q|: g / |q| - q (g . q) / |q|^3
  const double gq = (gw * q[0] + gx * q[1] + gy * q[2] + gz * q[3]) / (qden * qden * qden);
  p.g_quats[4 * i] = static_cast<float>(gw / qden - q[0] * gq);
  p.g_quats[4 * i + 1] = static_cast<float>(gx / qden - q[1] * gq);
  p.g_quats[4 * i + 2] = static_cast<float>(gy / qden - q[2] * gq);
  p.g_quats[4 * i + 3] = static_cast<float>(gz / qden - q[3] * gq);
  p.g_opac[i] = static_cast<float>(g_o);
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// means (n, 3), quats (n, 4), scales (n, 3), opacities (n,) or null, tap
// (n, 2) or null, viewmat (4, 4), K (3, 3): float32 on the device,
// contiguous. Outputs means2d (n, 2), conics (n, 3), depths, comps (n,)
// float32 and radii, radii_x, radii_y (n,) int32, all seven null for the
// table alone; the table (n + 1, 8) float32 on 16 bytes, or null (it needs
// opacities).
// `extents` shrinks radii_x / radii_y to the alpha-floor contour (needs
// opacities). Launches on `stream`; returns the launch's CUDA error.
int gags_project_forward(const void* means, const void* quats, const void* scales,
                         const void* opacities, const void* tap, const void* viewmat,
                         const void* K, int n, int width, int height, float eps2d,
                         float near_plane, float far_plane, int extents, int antialiased,
                         void* means2d, void* conics, void* depths, void* radii, void* comps,
                         void* radii_x, void* radii_y, void* table, void* stream) {
  FwdArgs a;
  a.means = static_cast<const float*>(means);
  a.quats = static_cast<const float*>(quats);
  a.scales = static_cast<const float*>(scales);
  a.opacities = static_cast<const float*>(opacities);
  a.tap = static_cast<const float*>(tap);
  a.vm = static_cast<const float*>(viewmat);
  a.K = static_cast<const float*>(K);
  a.n = n;
  a.width = width;
  a.height = height;
  a.extents = extents;
  a.antialiased = antialiased;
  a.eps2d = eps2d;
  a.near_plane = near_plane;
  a.far_plane = far_plane;
  a.means2d = static_cast<float*>(means2d);
  a.conics = static_cast<float*>(conics);
  a.depths = static_cast<float*>(depths);
  a.comps = static_cast<float*>(comps);
  a.table = static_cast<float*>(table);
  a.radii = static_cast<int*>(radii);
  a.radii_x = static_cast<int*>(radii_x);
  a.radii_y = static_cast<int*>(radii_y);
  const int blocks = (n + 1 + kThreads - 1) / kThreads;  // + 1: the sentinel row
  project_forward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The inputs as in gags_project_forward (opacities required), g_table (n +
// 1, 8) float32 on 16 bytes; outputs g_means (n, 3), g_quats (n, 4),
// g_scales (n, 3), g_opac (n,) float32. The constants come as float64, as
// the plain chain's Python scalars are. Returns the launch's CUDA error.
int gags_project_backward(const void* means, const void* quats, const void* scales,
                          const void* opacities, const void* viewmat, const void* K, int n,
                          int width, int height, double eps2d, double near_plane,
                          double far_plane, int antialiased, const void* g_table, void* g_means,
                          void* g_quats, void* g_scales, void* g_opac, void* stream) {
  if (n <= 0) return 0;
  BwdArgs a;
  a.means = static_cast<const float*>(means);
  a.quats = static_cast<const float*>(quats);
  a.scales = static_cast<const float*>(scales);
  a.opacities = static_cast<const float*>(opacities);
  a.vm = static_cast<const float*>(viewmat);
  a.K = static_cast<const float*>(K);
  a.g_table = static_cast<const float*>(g_table);
  a.n = n;
  a.width = width;
  a.height = height;
  a.antialiased = antialiased;
  a.eps2d = eps2d;
  a.near_plane = near_plane;
  a.far_plane = far_plane;
  a.g_means = static_cast<float*>(g_means);
  a.g_quats = static_cast<float*>(g_quats);
  a.g_scales = static_cast<float*>(g_scales);
  a.g_opac = static_cast<float*>(g_opac);
  const int blocks = (n + kThreads - 1) / kThreads;
  project_backward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
