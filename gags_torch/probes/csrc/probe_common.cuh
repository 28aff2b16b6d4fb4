// Elementwise helpers of the two probe kernels (vpu_chain.cu, slab_chain.cu).
//
// One rounding per operation, as the JAX probes and their eager PyTorch
// versions round: float32 arithmetic through the round-to-nearest
// intrinsics (no FMA contraction), bfloat16 arithmetic as packed
// bf16x2 PTX with an explicit .rn (sm_90: a single rounding of the exact
// result, which equals torch's round-to-bf16 of the float32 result, since a
// product of two bf16 values is exact in float32 and a sum of two rounds in
// float32 at no bf16 midpoint). exp2 and log1p run on the float32
// extension (exp2f / log1pf, the functions torch's CUDA ops call) and are
// rounded to bf16 once, as torch's bf16 exp2 and the probes' f32 log1p do.
// min propagates NaN, as torch.minimum does (PTX min.NaN).
//
// exp2f is the MUFU.EX2 instruction (ex2.approx.ftz.f32) wrapped in a
// range step that halves an argument below -126 and squares the result,
// to reach the subnormal results. exp2_mufu is the instruction alone: the
// same bits as exp2f wherever the argument is NaN or at least -126. The
// chains call it only where their arithmetic keeps the argument there, or
// where every result below 2^-126 is thrown away (each call says which).
// The packed ex2.approx.ftz.bf16x2 of sm_90 is not used: it does not give
// the float32 extension's bits on every bf16 input.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

typedef uint32_t bf2;  // two bfloat16 values, element 0 in the low half

__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) {
  bf2 r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) {
  bf2 r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ bf2 sub2(bf2 a, bf2 b) {
  bf2 r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ bf2 min2(bf2 a, bf2 b) {
  bf2 r;
  asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ float min1(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bf2 neg2(bf2 a) { return a ^ 0x80008000u; }

__device__ __forceinline__ float lo(bf2 a) { return __uint_as_float(a << 16); }
__device__ __forceinline__ float hi(bf2 a) { return __uint_as_float(a & 0xffff0000u); }

// (lo, hi) float32 → bf16x2, each rounded to nearest even
__device__ __forceinline__ bf2 pack2(float l, float h) {
  bf2 r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(h), "f"(l));
  return r;
}

__device__ __forceinline__ bf2 splat2(float v) { return pack2(v, v); }

__device__ __forceinline__ float exp2_mufu(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ bf2 exp2_2(bf2 a) { return pack2(exp2f(lo(a)), exp2f(hi(a))); }

// exp2_mufu per half, for the same arguments as exp2_mufu
__device__ __forceinline__ bf2 exp2_mufu2(bf2 a) {
  return pack2(exp2_mufu(lo(a)), exp2_mufu(hi(a)));
}

// where(keep, a, 0) per half; keep bit 0 for the low half, bit 1 for the high
__device__ __forceinline__ bf2 keep2(bf2 a, bool keep_lo, bool keep_hi) {
  return a & ((keep_lo ? 0x0000ffffu : 0u) | (keep_hi ? 0xffff0000u : 0u));
}

}  // namespace probe
