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
// Bound: at reps 1 the launch; at the rate shape the instruction issue
// rate (no FMA: each op is rounded once, so a mul and an add are two
// instructions; exp2f is a few instructions around one MUFU.EX2, of which
// the first exp2, whose argument is at least -1, needs only the MUFU), not
// the published float32 rate. Design: a thread takes one 16-byte access (4
// float32 or 4 bf16x2 pairs) and carries its four chains through the rep
// loop interleaved, so four independent chains hide each other's
// latency; the grid is one full wave at the occupancy the registers allow
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), a grid-stride loop
// takes the rest; the tail past the last whole access takes one element a
// thread.

#include "probe_common.cuh"

namespace {

using namespace probe;

__device__ __forceinline__ float chain(float x) {
  const float one = 1.0f, half = 0.5f;
  const float a = __fadd_rn(__fmul_rn(x, half), one);
  const float b = __fsub_rn(__fmul_rn(a, a), x);
  const float c = min1(b, one);
  const float e = exp2_mufu(-c);  // -c >= -1 or NaN
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
  const bf2 e = exp2_mufu2(neg2(c));  // -c >= -1 or NaN
  const bf2 f = sub2(mul2(e, half), b);
  const bf2 g = add2(mul2(e, f), a);
  const bf2 h = add2(mul2(g, e), f);
  const bf2 i = add2(h, mul2(b, c));
  const bf2 j = exp2_2(mul2(i, k));
  return add2(j, c);
}

// kLanes independent chains, interleaved in one rep loop
template <typename T, int kLanes>
__device__ __forceinline__ void chain_reps(T (&v)[kLanes], int reps) {
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = chain(v[l]);
  }
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vpu_chain_float_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                       int reps) {
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = t0; v < nvec; v += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[v];
    float c[4] = {a.x, a.y, a.z, a.w};
    chain_reps(c, reps);
    reinterpret_cast<float4*>(out)[v] = make_float4(c[0], c[1], c[2], c[3]);
  }
  for (long long e = nvec * 4 + t0; e < n; e += stride) {
    float c[1] = {x[e]};
    chain_reps(c, reps);
    out[e] = c[0];
  }
}

__global__ void __launch_bounds__(kThreads)
vpu_chain_bfloat_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long n,
                        int reps) {
  const long long nvec = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = t0; v < nvec; v += stride) {
    const uint4 a = reinterpret_cast<const uint4*>(x)[v];
    bf2 c[4] = {a.x, a.y, a.z, a.w};
    chain_reps(c, reps);
    reinterpret_cast<uint4*>(out)[v] = make_uint4(c[0], c[1], c[2], c[3]);
  }
  for (long long e = nvec * 8 + t0; e < n; e += stride) {
    bf2 c[1] = {static_cast<bf2>(x[e])};
    chain_reps(c, reps);
    out[e] = static_cast<uint16_t>(c[0] & 0xffffu);
  }
}

template <typename K>
int resident_blocks(K kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                             kThreads, 0);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(err);
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
  int wave = 0;
  const int err = bf16 ? resident_blocks(vpu_chain_bfloat_kernel, &wave)
                       : resident_blocks(vpu_chain_float_kernel, &wave);
  if (err != 0) return err;
  const long long per_thread = bf16 ? 8 : 4;
  const long long want = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  // one full wave at most: the grid-stride loop takes the rest
  const int blocks = static_cast<int>(want < wave ? want : wave);
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
