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
// The TPU's grid-less call ran on its whole core; here every slab spreads
// the block over all SMs. A thread block owns a band of whole rows and
// loops over it in passes of at most `slab` rows: a pass's rows are loaded,
// carried through all REPS applications in registers and stored before
// the next pass's rows are loaded, so the slab bounds a block's register
// working set. The launch geometry (blocks, threads, rows a band, rows a
// pass, chains a thread) is computed by the wrapper
// (slab_probe.launch_geometry). The output is the same for every slab.
// At the probe's (1024, 128) on 132 SMs a band is one row, so every slab
// launches the same grid: the card's register files hold the whole block
// at once, and the TPU's question of how many rows to carry has no
// counterpart at that shape.
//
// Bound: the instruction issue rate (log1pf is a software routine of ~25
// instructions, each exp2 one MUFU.EX2 here: probe_common.cuh's exp2_mufu,
// exact for these arguments; ~1,000 dependent instructions an element over
// the 24 applications), not the bytes. The block's 131,072 elements give
// each of the card's 528 schedulers ~250 chains, too few to hide the
// chain's latency fully. Design: one float32 element or one bf16x2 pair a
// chain, kLanes chains a thread (two float32 chains or one pair at least)
// carried through the rep loop interleaved, so independent chains hide
// each other's latency; many small blocks keep the SMs' shares within one
// block of even.

#include "probe_common.cuh"

namespace {

using namespace probe;

__device__ __forceinline__ float chain(float x) {
  const float lt = 0.0f;
  const float s2 = __fadd_rn(__fmul_rn(x, 0.5f), 1.0f);
  // below 2^-126 exp2 falls under the 1/255 floor whatever its bits
  float alpha = min1(0.999f, exp2_mufu(-s2));
  alpha = alpha >= static_cast<float>(1.0 / 255.0) ? alpha : 0.0f;
  const float l1m = log1pf(-alpha);
  const float cum = __fadd_rn(l1m, lt);
  // cum - l1m is 0: l1m is finite (alpha is 0 or in [1/255, 0.999])
  const float w = cum >= -8.0f ? __fmul_rn(alpha, exp2_mufu(__fsub_rn(cum, l1m))) : 0.0f;
  return __fadd_rn(w, __fmul_rn(s2, 1e-3f));
}

__device__ __forceinline__ bf2 chain(bf2 x) {
  const float floor_f = static_cast<float>(1.0 / 255.0);
  const bf2 lt = 0u;
  const bf2 s2 = add2(mul2(x, splat2(0.5f)), splat2(1.0f));
  bf2 alpha = min2(splat2(0.999f), exp2_mufu2(neg2(s2)));  // as in the float32 chain
  alpha = keep2(alpha, lo(alpha) >= floor_f, hi(alpha) >= floor_f);
  const bf2 l1m = pack2(log1pf(-lo(alpha)), log1pf(-hi(alpha)));
  const bf2 cum = add2(l1m, lt);
  const bf2 w =
      keep2(mul2(alpha, exp2_mufu2(sub2(cum, l1m))), lo(cum) >= -8.0f, hi(cum) >= -8.0f);
  return add2(w, mul2(s2, splat2(1e-3f)));
}

// One chain's value: a float32 element, or a bf16 pair (elements e, e + 1
// of the row-major block; an element at or past `end` reads 0 and is not
// stored).
template <bool kBf16>
struct Elem;

template <>
struct Elem<false> {
  typedef float T;
  static constexpr int kPer = 1;
  static __device__ __forceinline__ T load(const void* x, long long e, long long) {
    return static_cast<const float*>(x)[e];
  }
  static __device__ __forceinline__ void store(void* out, long long e, long long, T v) {
    static_cast<float*>(out)[e] = v;
  }
};

template <>
struct Elem<true> {
  typedef bf2 T;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ T load(const void* x, long long e, long long end) {
    const uint16_t* p = static_cast<const uint16_t*>(x);
    return static_cast<bf2>(p[e]) | (e + 1 < end ? static_cast<bf2>(p[e + 1]) << 16 : 0u);
  }
  static __device__ __forceinline__ void store(void* out, long long e, long long end, T v) {
    uint16_t* p = static_cast<uint16_t*>(out);
    p[e] = static_cast<uint16_t>(v & 0xffffu);
    if (e + 1 < end) p[e + 1] = static_cast<uint16_t>(v >> 16);
  }
};

// Block b: rows [b * band_rows, (b + 1) * band_rows) in passes of pass_rows;
// in a pass, thread t takes chains t, t + threads, ... (kLanes at a time).
template <bool kBf16, int kLanes>
__global__ void __launch_bounds__(1024)
slab_chain_kernel(const void* __restrict__ x, void* __restrict__ out, int rows, int cols,
                  int band_rows, int pass_rows, int reps) {
  typedef Elem<kBf16> E;
  const int r0 = blockIdx.x * band_rows;
  const int r1 = min(rows, r0 + band_rows);
  const long long step = static_cast<long long>(E::kPer) * blockDim.x;
  for (int p0 = r0; p0 < r1; p0 += pass_rows) {
    const long long begin = static_cast<long long>(p0) * cols;
    const long long end = static_cast<long long>(min(r1, p0 + pass_rows)) * cols;
    for (long long e0 = begin + E::kPer * threadIdx.x; e0 < end; e0 += kLanes * step) {
      typename E::T v[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const long long e = e0 + l * step;
        v[l] = e < end ? E::load(x, e, end) : typename E::T(0);
      }
#pragma unroll 1
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) v[l] = chain(v[l]);
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const long long e = e0 + l * step;
        if (e < end) E::store(out, e, end, v[l]);
      }
    }
  }
}

// The chains a thread carries: 2 or 4 float32 elements (two at least), 1, 2
// or 4 bf16 pairs (slab_probe.launch_geometry); only these are built.
void launch(const void* x, void* out, int rows, int cols, int blocks, int threads, int band_rows,
            int pass_rows, int lanes, int reps, bool bf16, cudaStream_t s) {
  if (bf16 && lanes >= 4) {
    slab_chain_kernel<true, 4><<<blocks, threads, 0, s>>>(x, out, rows, cols, band_rows,
                                                          pass_rows, reps);
  } else if (bf16 && lanes == 2) {
    slab_chain_kernel<true, 2><<<blocks, threads, 0, s>>>(x, out, rows, cols, band_rows,
                                                          pass_rows, reps);
  } else if (bf16) {
    slab_chain_kernel<true, 1><<<blocks, threads, 0, s>>>(x, out, rows, cols, band_rows,
                                                          pass_rows, reps);
  } else if (lanes >= 4) {
    slab_chain_kernel<false, 4><<<blocks, threads, 0, s>>>(x, out, rows, cols, band_rows,
                                                           pass_rows, reps);
  } else {
    slab_chain_kernel<false, 2><<<blocks, threads, 0, s>>>(x, out, rows, cols, band_rows,
                                                           pass_rows, reps);
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: (rows, cols) float32 (bf16 = 0) or bfloat16 (bf16 = 1) on the
// device; `blocks` blocks of `threads` threads, block b taking rows
// [b * band_rows, (b + 1) * band_rows) in passes of pass_rows rows, lanes
// chains a thread at a time (2 or 4 for float32, 1, 2 or 4 for bfloat16); reps >= 1 applications of the
// chain. Launches on `stream` and returns the first CUDA error of the
// launch.
int gags_slab_chain(const void* x, void* out, int rows, int cols, int blocks, int threads,
                    int band_rows, int pass_rows, int lanes, int reps, int bf16, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  launch(x, out, rows, cols, blocks, threads, band_rows, pass_rows, lanes, reps, bf16 != 0,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
