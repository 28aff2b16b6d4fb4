// vpu_chain: the elementwise chain of the TPU probe scripts/vpu_probe.py.
//
// Replaces the TPU kernel scripts/vpu_probe.py:make.run (the pallas_call at
// :36, body `kernel`): one pass of an 18-op chain over a (512, 256) block,
//
//     a = x*0.5 + 1        b = a*a - x          c = min(b, 1)
//     e = exp2(-c)         f = e*0.5 - b        g = e*f + a
//     h = g*e + f          i = h + b*c          j = exp2(i * -0.01)
//     out = j + c
//
// in float32 or bfloat16, each operation rounded once to the working type
// (probe_common.cuh). `reps` applies the chain that many times in
// registers between one load and one store: reps = 1 is the TPU probe's
// contract; a larger reps makes the pass bound by arithmetic, so its time
// gives the card's elementwise rate in each type (the probe's question: is
// bf16 twice f32?). bf16 runs as packed bf16x2 arithmetic; its two exp2 an
// element run on the float32 extension, as torch's bf16 exp2 does.
//
// Design: one thread takes one 16-byte access (4 float32 or 8 bf16
// elements) per round of a grid-stride loop; the tail past the last whole
// access takes one element a thread.

#include "probe_common.cuh"

namespace {

using namespace probe;

__device__ __forceinline__ float chain(float x) {
  const float one = 1.0f, half = 0.5f;
  const float a = __fadd_rn(__fmul_rn(x, half), one);
  const float b = __fsub_rn(__fmul_rn(a, a), x);
  const float c = fminf(b, one);
  const float e = exp2f(-c);
  const float f = __fsub_rn(__fmul_rn(e, half), b);
  const float g = __fadd_rn(__fmul_rn(e, f), a);
  const float h = __fadd_rn(__fmul_rn(g, e), f);
  const float i = __fadd_rn(h, __fmul_rn(b, c));
  const float j = exp2f(__fmul_rn(i, -0.01f));
  return __fadd_rn(j, c);
}

__device__ __forceinline__ bf2 chain(bf2 x) {
  const bf2 one = splat2(1.0f), half = splat2(0.5f), k = splat2(-0.01f);
  const bf2 a = add2(mul2(x, half), one);
  const bf2 b = sub2(mul2(a, a), x);
  const bf2 c = min2(b, one);
  const bf2 e = exp2_2(neg2(c));
  const bf2 f = sub2(mul2(e, half), b);
  const bf2 g = add2(mul2(e, f), a);
  const bf2 h = add2(mul2(g, e), f);
  const bf2 i = add2(h, mul2(b, c));
  const bf2 j = exp2_2(mul2(i, k));
  return add2(j, c);
}

template <typename T>
__device__ __forceinline__ T chain_reps(T v, int reps) {
#pragma unroll 1
  for (int r = 0; r < reps; ++r) v = chain(v);
  return v;
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vpu_chain_float_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                       int reps) {
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = t0; v < nvec; v += stride) {
    float4 a = reinterpret_cast<const float4*>(x)[v];
    a.x = chain_reps(a.x, reps);
    a.y = chain_reps(a.y, reps);
    a.z = chain_reps(a.z, reps);
    a.w = chain_reps(a.w, reps);
    reinterpret_cast<float4*>(out)[v] = a;
  }
  for (long long e = nvec * 4 + t0; e < n; e += stride) out[e] = chain_reps(x[e], reps);
}

__global__ void __launch_bounds__(kThreads)
vpu_chain_bfloat_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long n,
                      int reps) {
  const long long nvec = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = t0; v < nvec; v += stride) {
    uint4 a = reinterpret_cast<const uint4*>(x)[v];
    a.x = chain_reps(a.x, reps);
    a.y = chain_reps(a.y, reps);
    a.z = chain_reps(a.z, reps);
    a.w = chain_reps(a.w, reps);
    reinterpret_cast<uint4*>(out)[v] = a;
  }
  for (long long e = nvec * 8 + t0; e < n; e += stride) {
    const bf2 r = chain_reps(static_cast<bf2>(x[e]), reps);
    out[e] = static_cast<uint16_t>(r & 0xffffu);
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: (n,) float32 (bf16 = 0) or bfloat16 (bf16 = 1) on the device, on
// 16 bytes; reps >= 1 applications of the chain. Launches on `stream` and
// returns the first CUDA error of sizing the grid or of the launch.
int gags_vpu_chain(const void* x, void* out, long long n, int reps, int bf16, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_thread = bf16 ? 8 : 4;
  const long long want = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  // at most 8 blocks of 256 threads an SM: the loop takes the rest
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    vpu_chain_bfloat_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint16_t*>(x),
                                                      static_cast<uint16_t*>(out), n, reps);
  } else {
    vpu_chain_float_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(out), n, reps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
