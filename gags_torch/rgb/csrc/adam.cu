// adam: J5, the RGB step's update in one launch: Adam on the six parameter
// groups (rgb/train.py `_adam_update`), the parking of dead slots' means
// and the densification statistics.
//
// Replaces no TPU kernel: the JAX package writes the update as
// elementwise operations that XLA fuses per group. PyTorch runs them
// eagerly, 14 launches a group and ~16 for the parking and the statistics,
// each a pass over the group in device memory.
//
// Every value equals the eager chain's on the card bit for bit. Adam per
// element, in `_adam_update`'s order:
//   mu = b1 mu + (1 - b1) g;  nu = b2 nu + ((1 - b2) g) g;
//   p = p - (lr (mu c1')) / (sqrt(nu c2') + eps)
// with each operation a round-to-nearest intrinsic (no FMA contraction),
// each Python scalar its float32 rounding, and c1', c2' the float32
// reciprocals of the bias corrections, computed on the host: PyTorch
// divides a CUDA tensor by a host scalar as a product with its float32
// reciprocal. Then the means of a slot not alive become (0, 0, dead_z),
// and a slot's statistics take its screen-space gradient's norm in
// (W/2, H/2) units, ((gx (W/2))^2 + (gy (H/2))^2) summed as PyTorch's
// two-element norm sums it, where its radius is positive; the views that
// saw it; its largest radius.
//
// What bounds it on the H100: bytes, 28 a parameter element (p, g, mu, nu
// read; p, mu, nu written) and 28 a slot for the statistics; at 400k slots
// of SH degree 3, 23.6M elements, 0.67 GB, ~0.2 ms. A block takes 1,024
// consecutive elements of one group, four a thread with loads that
// coalesce; the block's group comes from a table of the groups' first
// blocks, passed by value with the pointers, sizes and learning rates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;
constexpr int kMaxGroups = 6;  // rgb/kernels.py ADAM_GROUPS: the RGB step's six

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

struct Group {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int64_t n;
  int64_t block0;  // the group's first block
  float lr;
};

struct Args {
  Group grp[kMaxGroups];
  int groups;
  float b1, omb1, b2, omb2, rc1, rc2, eps;
  // parking: group 0's rows of 3 where alive[row] is false
  const bool* alive;
  float dead_z;
  // statistics over `slots` rows from block stats_block0 on
  const float* g2d;  // (slots, 2)
  const int* radii;
  float half_w, half_h;
  float *grad_accum, *denom, *max_radii;
  int64_t slots, stats_block0;
};

__device__ __forceinline__ void adam_element(const Args& a, const Group& gr, int64_t e,
                                             bool park) {
  const float g = gr.g[e];
  const float mu = fa(fm(a.b1, gr.mu[e]), fm(a.omb1, g));
  const float nu = fa(fm(a.b2, gr.nu[e]), fm(fm(a.omb2, g), g));
  gr.mu[e] = mu;
  gr.nu[e] = nu;
  const float step = __fdiv_rn(fm(gr.lr, fm(mu, a.rc1)), fa(__fsqrt_rn(fm(nu, a.rc2)), a.eps));
  float p = fs(gr.p[e], step);
  if (park && !a.alive[e / 3]) p = (e % 3 == 2) ? a.dead_z : 0.0f;
  gr.p[e] = p;
}

__device__ __forceinline__ void stats_slot(const Args& a, int64_t i) {
  const float gx = fm(a.g2d[2 * i], a.half_w), gy = fm(a.g2d[2 * i + 1], a.half_h);
  const float norm = __fsqrt_rn(fa(fm(gx, gx), fm(gy, gy)));
  const int rad = a.radii[i];
  const bool vis = rad > 0;
  a.grad_accum[i] = fa(a.grad_accum[i], vis ? norm : 0.0f);
  a.denom[i] = fa(a.denom[i], vis ? 1.0f : 0.0f);
  const float m = a.max_radii[i], rf = static_cast<float>(rad);
  a.max_radii[i] = m != m ? m : fmaxf(m, rf);  // torch.maximum: NaN propagates
}

__global__ void __launch_bounds__(kThreads) adam_kernel(Args a) {
  const int64_t b = blockIdx.x;
  if (b >= a.stats_block0) {
    const int64_t i0 = (b - a.stats_block0) * kBlockElems + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t i = i0 + j * kThreads;
      if (i < a.slots) stats_slot(a, i);
    }
    return;
  }
  int k = 0;
  while (k + 1 < a.groups && b >= a.grp[k + 1].block0) ++k;
  const Group& gr = a.grp[k];
  const bool park = k == 0;
  const int64_t e0 = (b - gr.block0) * kBlockElems + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t e = e0 + j * kThreads;
    if (e < gr.n) adam_element(a, gr, e, park);
  }
}

int64_t blocks_of(int64_t n) { return (n + kBlockElems - 1) / kBlockElems; }

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// groups parameter groups: p, g, mu, nu (n[i] float32 each) and lr[i].
// b1 .. eps: float32 scalars as the eager chain rounds them; rc1, rc2 the
// float32 reciprocals of the bias corrections. alive (n[0] / 3 bools) parks
// group 0's rows; g2d (slots, 2), radii (slots,) int32 update grad_accum,
// denom and max_radii (slots,).
int gags_adam_update(int groups, float** p, const float** g, float** mu, float** nu,
                     const int64_t* n, const float* lr, float b1, float omb1, float b2,
                     float omb2, float rc1, float rc2, float eps, const bool* alive,
                     float dead_z, const float* g2d, const int* radii, float half_w,
                     float half_h, float* grad_accum, float* denom, float* max_radii,
                     int64_t slots, void* stream) {
  if (groups < 1 || groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int64_t blocks = 0;
  for (int i = 0; i < groups; ++i) {
    a.grp[i] = Group{p[i], g[i], mu[i], nu[i], n[i], blocks, lr[i]};
    blocks += blocks_of(n[i]);
  }
  a.groups = groups;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.rc1 = rc1;
  a.rc2 = rc2;
  a.eps = eps;
  a.alive = alive;
  a.dead_z = dead_z;
  a.g2d = g2d;
  a.radii = radii;
  a.half_w = half_w;
  a.half_h = half_h;
  a.grad_accum = grad_accum;
  a.denom = denom;
  a.max_radii = max_radii;
  a.slots = slots;
  a.stats_block0 = blocks;
  blocks += blocks_of(slots);
  if (blocks == 0) return 0;
  adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
