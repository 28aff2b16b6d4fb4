// slab_chain: the blend alpha chain of the TPU probe scripts/slab_probe.py.
//
// Replaces the TPU kernel scripts/slab_probe.py:make.run (the pallas_call
// at :71, body `kernel`, chain `chain` :23): REPS applications (24 in the
// probe) of
//
//     s2 = x*0.5 + 1                   alpha = min(0.999, exp2(-s2))
//     alpha = alpha >= 1/255 ? alpha : 0        (compare on float32)
//     l1m = log1p(-alpha)                       (on float32, then rounded)
//     cum = l1m + lt                            (lt = 0, a (rows, 1) column)
//     w = cum >= -8 ? alpha * exp2(cum - l1m) : 0   (compare on float32)
//     out = w + s2 * 1e-3
//
// over a (1024, 128) block, float32 or bfloat16, each operation rounded
// once to the working type (probe_common.cuh). The TPU probe runs the
// chain on the whole block at once or in a loop over row slabs of 256,
// 64, 32 or 8 rows, to see whether Mosaic streams every op through VMEM.
// Here a slab is the rows of one thread block (no slab: one block for the
// whole array, as the TPU's single grid-less call), so the slab sets how
// many SMs share the work. The output is the same for every slab.
//
// Design: a thread takes one 16-byte access (4 float32 or 8 bf16
// elements) per round of a loop over its block's rows, and keeps the
// chain's REPS applications in registers; a slab whose elements are not a
// whole number of accesses takes one element a thread.

#include "probe_common.cuh"

namespace {

using namespace probe;

__device__ __forceinline__ float chain(float x) {
  const float lt = 0.0f;
  const float s2 = __fadd_rn(__fmul_rn(x, 0.5f), 1.0f);
  float alpha = fminf(0.999f, exp2f(-s2));
  alpha = alpha >= static_cast<float>(1.0 / 255.0) ? alpha : 0.0f;
  const float l1m = log1pf(-alpha);
  const float cum = __fadd_rn(l1m, lt);
  const float w = cum >= -8.0f ? __fmul_rn(alpha, exp2f(__fsub_rn(cum, l1m))) : 0.0f;
  return __fadd_rn(w, __fmul_rn(s2, 1e-3f));
}

__device__ __forceinline__ bf2 chain(bf2 x) {
  const float floor_f = static_cast<float>(1.0 / 255.0);
  const bf2 lt = 0u;
  const bf2 s2 = add2(mul2(x, splat2(0.5f)), splat2(1.0f));
  bf2 alpha = min2(splat2(0.999f), exp2_2(neg2(s2)));
  alpha = keep2(alpha, lo(alpha) >= floor_f, hi(alpha) >= floor_f);
  const bf2 l1m = pack2(log1pf(-lo(alpha)), log1pf(-hi(alpha)));
  const bf2 cum = add2(l1m, lt);
  const bf2 w = keep2(mul2(alpha, exp2_2(sub2(cum, l1m))), lo(cum) >= -8.0f, hi(cum) >= -8.0f);
  return add2(w, mul2(s2, splat2(1e-3f)));
}

template <typename T>
__device__ __forceinline__ T chain_reps(T v, int reps) {
#pragma unroll 1
  for (int r = 0; r < reps; ++r) v = chain(v);
  return v;
}

template <bool kVector>
__global__ void slab_chain_float_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      long long slab_elems, long long n, int reps) {
  const long long e0 = static_cast<long long>(blockIdx.x) * slab_elems;
  const long long e1 = e0 + slab_elems < n ? e0 + slab_elems : n;
  if (kVector) {
    for (long long e = e0 + 4LL * threadIdx.x; e < e1; e += 4LL * blockDim.x) {
      float4 a = *reinterpret_cast<const float4*>(x + e);
      a.x = chain_reps(a.x, reps);
      a.y = chain_reps(a.y, reps);
      a.z = chain_reps(a.z, reps);
      a.w = chain_reps(a.w, reps);
      *reinterpret_cast<float4*>(out + e) = a;
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) out[e] = chain_reps(x[e], reps);
  }
}

template <bool kVector>
__global__ void slab_chain_bfloat_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                                       long long slab_elems, long long n, int reps) {
  const long long e0 = static_cast<long long>(blockIdx.x) * slab_elems;
  const long long e1 = e0 + slab_elems < n ? e0 + slab_elems : n;
  if (kVector) {
    for (long long e = e0 + 8LL * threadIdx.x; e < e1; e += 8LL * blockDim.x) {
      uint4 a = *reinterpret_cast<const uint4*>(x + e);
      a.x = chain_reps(a.x, reps);
      a.y = chain_reps(a.y, reps);
      a.z = chain_reps(a.z, reps);
      a.w = chain_reps(a.w, reps);
      *reinterpret_cast<uint4*>(out + e) = a;
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      out[e] = static_cast<uint16_t>(chain_reps(static_cast<bf2>(x[e]), reps) & 0xffffu);
    }
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: (rows, cols) float32 (bf16 = 0) or bfloat16 (bf16 = 1) on the
// device, on 16 bytes; slab_rows rows a thread block (slab_rows >= rows:
// one block); reps >= 1 applications of the chain. Launches on `stream`
// and returns the first CUDA error of the launch.
int gags_slab_chain(const void* x, void* out, int rows, int cols, int slab_rows, int reps,
                    int bf16, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (slab_rows <= 0 || slab_rows > rows) slab_rows = rows;
  const long long n = static_cast<long long>(rows) * cols;
  const long long slab_elems = static_cast<long long>(slab_rows) * cols;
  const int blocks = (rows + slab_rows - 1) / slab_rows;
  const int per_access = bf16 ? 8 : 4;
  const bool vector = slab_elems % per_access == 0;
  const long long accesses = vector ? slab_elems / per_access : slab_elems;
  // one access a thread where the slab has at most 1024; the loop takes the rest
  const int threads =
      static_cast<int>(accesses >= 1024 ? 1024 : ((accesses + 31) / 32) * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  uint16_t* ob = static_cast<uint16_t*>(out);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (bf16 && vector) {
    slab_chain_bfloat_kernel<true><<<blocks, threads, 0, s>>>(xb, ob, slab_elems, n, reps);
  } else if (bf16) {
    slab_chain_bfloat_kernel<false><<<blocks, threads, 0, s>>>(xb, ob, slab_elems, n, reps);
  } else if (vector) {
    slab_chain_float_kernel<true><<<blocks, threads, 0, s>>>(xf, of, slab_elems, n, reps);
  } else {
    slab_chain_float_kernel<false><<<blocks, threads, 0, s>>>(xf, of, slab_elems, n, reps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
