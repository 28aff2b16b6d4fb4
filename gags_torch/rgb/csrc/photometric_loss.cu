// photometric_loss: J4, the RGB step's loss (1 - lam) L1 + lam (1 - SSIM)
// of a rendered image against its target, both (H, W, 3) float32, and its
// gradient with respect to the rendered image.
//
// Replaces no TPU kernel: the JAX package writes the loss with
// jax.lax.conv and elementwise operations that XLA fuses. PyTorch runs it
// eagerly: the five maps stacked by a cat, two depthwise convolutions, the
// SSIM map, the means, and autograd's backward of each, ~80 launches.
//
// SSIM as utils/metrics.ssim computes it: the separable 11-tap Gaussian
// window (its float32 taps, computed on the host, passed by value) with
// zero "same" borders, C1 = 0.01^2, C2 = 0.03^2, the mean over every pixel
// and channel.
//
// Forward (gags_loss_forward): a block filters a 16 x 16 tile of every
// channel from a (16 + 10)^2 patch in shared memory, vertically and then
// horizontally, sums its SSIM terms and absolute differences, and writes
// the two block sums; the last block to finish (a ticket counter that it
// resets for the next launch) adds them in block order, so the loss is
// deterministic, and writes it. The filter sums and the means are float64.
//
// Backward (gags_loss_backward): with G the loss's gradient over the
// H * W * 3 terms, dL/dimg = F(P1) + 2 img F(P11) + gt F(P12) + (1 - lam)
// G sign(img - gt), where F is the same zero-bordered filter (the adjoint
// of a symmetric "same" filter is itself), and P1, P11, P12 are -lam G
// times the SSIM term's derivatives with respect to mu1, the filtered img^2
// and the filtered img * gt. A block recomputes the filtered maps over its
// tile grown by 5 pixels (from a patch grown by 10), forms the P maps there
// (zero outside the image) and filters them onto its tile, all in float64
// in shared memory.
//
// What bounds it on the H100: bytes are 22 MB forward (both images read
// once) and 33 MB backward (and the gradient written), 7-10 us; the
// filters' float64 arithmetic on the halos, ~2.5 and ~7 G float64
// operations a 1280 x 720 image, is the larger bound. A thread a pixel of
// a 16 x 16 tile keeps the halo in shared memory and reads each input
// byte from device memory about twice (neighbouring tiles' halos).
//
// Why float64 and not float32: the variance terms (filtered img^2 less
// mu1^2) cancel where an image is flat, and the same closed forms in
// float32 give an image gradient 1e-5 to 3e-5 (relative L2) away from
// float64's on a 640 x 360 image, against the 1e-6 its tests hold.
// Compensated float32 sums would not help: the loss is in the subtraction,
// not in the sums.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kR = 5;  // the window's radius
constexpr int kWin = 2 * kR + 1;
constexpr int kThreads = kTile * kTile;
constexpr double kC1 = 0.01 * 0.01;
constexpr double kC2 = 0.03 * 0.03;

struct Window {
  float w[kWin];
};

// The SSIM term's pieces at one pixel from its five filtered maps.
struct Ssim {
  double a, b, c, d, m;  // m = a b / (c d)
  __device__ __forceinline__ Ssim(double mu1, double mu2, double f11, double f22, double f12) {
    const double mu12 = mu1 * mu2;
    a = 2.0 * mu12 + kC1;
    b = 2.0 * (f12 - mu12) + kC2;
    c = mu1 * mu1 + mu2 * mu2 + kC1;
    d = (f11 - mu1 * mu1) + (f22 - mu2 * mu2) + kC2;
    m = (a * b) / (c * d);
  }
};

// Load channel `ch` of img and gt over rows [y0, y0 + side) and columns
// [x0, x0 + side) into x[side * side] and y[side * side], zero outside the
// image.
__device__ __forceinline__ void load_patch(const float* __restrict__ img,
                                           const float* __restrict__ gt, int h, int w, int ch,
                                           int y0, int x0, int side, float* x, float* y) {
  for (int e = threadIdx.x; e < side * side; e += kThreads) {
    const int r = e / side, q = e - r * side;
    const int gy = y0 + r, gx = x0 + q;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int64_t o = 3 * (static_cast<int64_t>(gy) * w + gx) + ch;
    x[e] = in ? img[o] : 0.0f;
    y[e] = in ? gt[o] : 0.0f;
  }
}

// The five maps' vertical pass: v[q][r][col] (rows r < rows, columns col <
// cols, row stride cols) = sum over taps of the window times x, y, x^2,
// y^2, x y at rows r .. r + 10 of the patch (row stride cols).
__device__ __forceinline__ void vertical5(const Window& win, const float* x, const float* y,
                                          int rows, int cols, double* v) {
  const int plane = rows * cols;
  for (int e = threadIdx.x; e < plane; e += kThreads) {
    double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const double a = x[e + t * cols], b = y[e + t * cols], wt = win.w[t];
      s[0] += wt * a;
      s[1] += wt * b;
      s[2] += wt * (a * a);
      s[3] += wt * (b * b);
      s[4] += wt * (a * b);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) v[q * plane + e] = s[q];
  }
}

// The horizontal pass of map q at (r, col): sum over taps of v[q][r][col + t].
__device__ __forceinline__ double horizontal(const Window& win, const double* v, int plane,
                                             int cols, int q, int r, int col) {
  const double* p = v + q * plane + r * cols + col;
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < kWin; ++t) s += static_cast<double>(win.w[t]) * p[t];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    loss_forward_kernel(const float* __restrict__ img, const float* __restrict__ gt, int h,
                        int w, Window win, double lam, double* __restrict__ partials,
                        unsigned int* __restrict__ ticket, float* __restrict__ loss) {
  constexpr int kSide = kTile + 2 * kR;  // 26
  __shared__ float x[kSide * kSide], y[kSide * kSide];
  __shared__ double v[5 * kTile * kSide];
  __shared__ double red[2][kThreads / 32];
  __shared__ bool last;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int r = threadIdx.x / kTile, col = threadIdx.x % kTile;
  const bool in = ty0 + r < h && tx0 + col < w;
  double sum_m = 0.0, sum_l1 = 0.0;
  for (int ch = 0; ch < 3; ++ch) {
    load_patch(img, gt, h, w, ch, ty0 - kR, tx0 - kR, kSide, x, y);
    __syncthreads();
    vertical5(win, x, y, kTile, kSide, v);
    __syncthreads();
    if (in) {
      const int plane = kTile * kSide;
      const Ssim s(horizontal(win, v, plane, kSide, 0, r, col),
                   horizontal(win, v, plane, kSide, 1, r, col),
                   horizontal(win, v, plane, kSide, 2, r, col),
                   horizontal(win, v, plane, kSide, 3, r, col),
                   horizontal(win, v, plane, kSide, 4, r, col));
      const int c = (r + kR) * kSide + col + kR;
      sum_m += s.m;
      sum_l1 += fabs(static_cast<double>(x[c]) - static_cast<double>(y[c]));
    }
    __syncthreads();
  }
  // the block's two sums, then the last block's total
  for (int o = 16; o > 0; o >>= 1) {
    sum_m += __shfl_down_sync(0xffffffffu, sum_m, o);
    sum_l1 += __shfl_down_sync(0xffffffffu, sum_l1, o);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    red[0][warp] = sum_m;
    red[1][warp] = sum_l1;
  }
  __syncthreads();
  const unsigned int blocks = gridDim.x * gridDim.y;
  const unsigned int bid = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    partials[2 * bid] = a;
    partials[2 * bid + 1] = b;
    __threadfence();
    last = atomicAdd(ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double a = 0.0, b = 0.0;
  for (unsigned int i = threadIdx.x; i < blocks; i += kThreads) {
    a += __ldcg(partials + 2 * i);
    b += __ldcg(partials + 2 * i + 1);
  }
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sm = 0.0, sl = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) {
      sm += red[0][i];
      sl += red[1][i];
    }
    const double n = 3.0 * static_cast<double>(h) * static_cast<double>(w);
    loss[0] = static_cast<float>((1.0 - lam) * (sl / n) + lam * (1.0 - sm / n));
    *ticket = 0u;  // ready for the next launch on the stream
  }
}

// Shared memory of the backward: the patch grown by 10 (float), the five
// maps' vertical pass over the tile grown by 5 (float64, reused for the P
// maps' vertical pass) and the P maps over the tile grown by 5 (float64).
constexpr int kBwdSide = kTile + 4 * kR;  // 36
constexpr int kMid = kTile + 2 * kR;      // 26
constexpr size_t kBwdSmem = 2 * kBwdSide * kBwdSide * sizeof(float) +
                            5 * kMid * kBwdSide * sizeof(double) +
                            3 * kMid * kMid * sizeof(double);

__global__ void __launch_bounds__(kThreads)
    loss_backward_kernel(const float* __restrict__ img, const float* __restrict__ gt, int h,
                         int w, Window win, double lam, const float* __restrict__ g_loss,
                         float* __restrict__ g_img) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* v = reinterpret_cast<double*>(smem_raw);     // [5][kMid][kBwdSide]
  double* p = v + 5 * kMid * kBwdSide;                 // [3][kMid][kMid]
  float* x = reinterpret_cast<float*>(p + 3 * kMid * kMid);  // [kBwdSide]^2
  float* y = x + kBwdSide * kBwdSide;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const double n = 3.0 * static_cast<double>(h) * static_cast<double>(w);
  const double g = static_cast<double>(*g_loss);
  const double g_m = -lam * g / n, g_l1 = (1.0 - lam) * g / n;
  const int r = threadIdx.x / kTile, col = threadIdx.x % kTile;
  for (int ch = 0; ch < 3; ++ch) {
    load_patch(img, gt, h, w, ch, ty0 - 2 * kR, tx0 - 2 * kR, kBwdSide, x, y);
    __syncthreads();
    vertical5(win, x, y, kMid, kBwdSide, v);
    __syncthreads();
    // the P maps over the tile grown by 5, zero outside the image
    const int plane = kMid * kBwdSide, pplane = kMid * kMid;
    for (int e = threadIdx.x; e < pplane; e += kThreads) {
      const int pr = e / kMid, pc = e - pr * kMid;
      const int gy = ty0 - kR + pr, gx = tx0 - kR + pc;
      double p1 = 0.0, p11 = 0.0, p12 = 0.0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const double mu1 = horizontal(win, v, plane, kBwdSide, 0, pr, pc);
        const double mu2 = horizontal(win, v, plane, kBwdSide, 1, pr, pc);
        const Ssim s(mu1, mu2, horizontal(win, v, plane, kBwdSide, 2, pr, pc),
                     horizontal(win, v, plane, kBwdSide, 3, pr, pc),
                     horizontal(win, v, plane, kBwdSide, 4, pr, pc));
        const double cd = s.c * s.d;
        // dm/dmu1, dm/df11, dm/df12
        p1 = g_m * 2.0 * (mu2 * (s.b - s.a) - s.m * mu1 * (s.d - s.c)) / cd;
        p11 = g_m * -s.m / s.d;
        p12 = g_m * 2.0 * s.a / cd;
      }
      p[e] = p1;
      p[pplane + e] = p11;
      p[2 * pplane + e] = p12;
    }
    __syncthreads();
    // the P maps' vertical pass onto the tile's rows (into v), then the
    // horizontal pass at the thread's pixel
    const int vplane = kTile * kMid;
    for (int e = threadIdx.x; e < vplane; e += kThreads) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        double s = 0.0;
#pragma unroll
        for (int t = 0; t < kWin; ++t) {
          s += static_cast<double>(win.w[t]) * p[q * pplane + e + t * kMid];
        }
        v[q * vplane + e] = s;
      }
    }
    __syncthreads();
    const int gy = ty0 + r, gx = tx0 + col;
    if (gy < h && gx < w) {
      const int c = (r + 2 * kR) * kBwdSide + col + 2 * kR;
      const double xv = x[c], yv = y[c];
      const double f1 = horizontal(win, v, vplane, kMid, 0, r, col);
      const double f11 = horizontal(win, v, vplane, kMid, 1, r, col);
      const double f12 = horizontal(win, v, vplane, kMid, 2, r, col);
      const double diff = xv - yv;
      const double sgn = diff > 0.0 ? 1.0 : (diff < 0.0 ? -1.0 : 0.0);
      g_img[3 * (static_cast<int64_t>(gy) * w + gx) + ch] =
          static_cast<float>(f1 + 2.0 * xv * f11 + yv * f12 + g_l1 * sgn);
    }
    __syncthreads();
  }
}

dim3 tiles(int h, int w) { return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile); }

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the forward: partials needs 2 float64 a block.
int gags_loss_blocks(int h, int w) {
  const dim3 g = tiles(h, w);
  return static_cast<int>(g.x * g.y);
}

// img, gt (h, w, 3); taps (11,) on the host; partials (2 x blocks) float64
// scratch; ticket: one zeroed uint32 that the launch leaves zeroed; loss (1,).
int gags_loss_forward(const float* img, const float* gt, int h, int w, const float* taps,
                      double lam, double* partials, unsigned int* ticket, float* loss,
                      void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Window win;
  for (int t = 0; t < kWin; ++t) win.w[t] = taps[t];
  loss_forward_kernel<<<tiles(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, gt, h, w, win, lam, partials, ticket, loss);
  return static_cast<int>(cudaGetLastError());
}

// g_loss: the loss's gradient, one float on the device -> g_img (h, w, 3).
int gags_loss_backward(const float* img, const float* gt, int h, int w, const float* taps,
                       double lam, const float* g_loss, float* g_img, void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Window win;
  for (int t = 0; t < kWin; ++t) win.w[t] = taps[t];
  // the shared memory above 48 KB, asked for once a device (a call per
  // launch costs the host more than the launch). A device's bit is set
  // only after its call returns, so a thread that sees it launches with
  // the attribute in place; threads that race both make the call.
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(loss_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured.fetch_or(bit);
  }
  loss_backward_kernel<<<tiles(h, w), kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      img, gt, h, w, win, lam, g_loss, g_img);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
