// supervision: J6, the GAD step's per-pixel tail in one kernel each way:
// the feature decoder's L2 normalisation, the scale-blended GT gather, the
// mask and the masked per-pixel L1 (gad/supervision.py
// `normalised_supervision_l1`).
//
// Replaces no TPU kernel: the JAX package writes this chain as array
// operations that XLA fuses. PyTorch runs it eagerly, ~30 passes over a
// (P, D) float32 tensor forward and ~60 backward (the normalisation's
// square, sum, rsqrt and product; three table gathers each multiplied by a
// strided scale column; the mask's products, the difference, abs and mean;
// a backward that gathers the GT map again and contracts three more
// gathers for the scale map's gradient), ~43 GB a step at 640 x 360 x 512.
//
// Per pixel p, with x the decoder's last layer before the normalisation
// (D floats), ids the pixel's s/m/l mask ids, s its three scale weights and
// T the (M, D) embedding table (float32 or float16):
//   y    = x rsqrt(max(sum x^2, 1e-24))
//   gt   = (T[s id] s0 + T[m id] s1) + T[l id] s2   (ids wrap as
//          torch.remainder: -1 reads the last row)
//   mask = all three ids != -1
//   l1   = mean_c |y - gt| where mask, else 0
// Backward, from g (P,): with sgn = sign(y - gt) and gm = g / D,
//   d_x     = rsqrt(.) gm (sgn - y <sgn, y>)   (<., .> dropped where the
//             clamp holds: sum x^2 < 1e-24)
//   d_scale = -<sgn, T[id_k]> gm for k = s, m, l
// both exact zeros where the mask is off. gt's products and sums and the
// difference are round-to-nearest intrinsics, no FMA contraction, in the
// eager chain's order, so sgn agrees with the eager chain wherever y does;
// the row sums are float32, over each lane's 4D/128 values and then a
// shuffle tree.
//
// What bounds it on the H100: bytes. Forward reads the rows once (4D bytes
// a pixel) and writes 4; backward reads them and writes their gradient (8D
// bytes a pixel). At P = 230,400, D = 512: 0.48 / 0.95 GB, 0.143 / 0.285 ms
// at 3.35 TB/s; ~0.014 operations a byte. A warp takes one pixel's row,
// 16-byte loads, D / 128 of them a lane; a block walks a run of 32
// neighbouring pixels with 8 warps, which mostly share their s/m/l ids, so
// the table's rows (0.6 MB, L2-resident) come from the SM's L1. Rows and
// their gradient stream past the caches (evict-first loads and stores).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;  // a run of neighbouring pixels a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// four consecutive table values from element e of a row, as float32
__device__ __forceinline__ float4 load4(const float* row, int e) {
  return __ldg(reinterpret_cast<const float4*>(row + e));
}

__device__ __forceinline__ float4 load4(const __half* row, int e) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + e));
  __half2 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sgn(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

template <typename T>
struct Args {
  const float* x;      // (n, d) the rows before the normalisation
  const T* table;      // (m, d)
  const int* ids;      // (n, 3) with row stride ids_stride
  const float* scale;  // (n, 3) with row stride scale_stride (0: one row for all)
  const float* g;      // (n,) backward only
  float* l1;           // (n,) forward only
  float* d_x;          // (n, d) backward only
  float* d_scale;      // (n, 3) backward only
  int64_t n, ids_stride, scale_stride;
  int m;
  float inv_d;  // 1 / d in float32, as a mean's reduction scales its sum
  float d;
};

struct Pixel {
  int row[3];  // the table rows, wrapped
  float s[3];
  bool valid;
};

template <typename T>
__device__ __forceinline__ Pixel load_pixel(const Args<T>& a, int64_t p) {
  Pixel px;
  px.valid = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int id = __ldg(a.ids + p * a.ids_stride + k);
    px.valid = px.valid && id != -1;
    int r = id % a.m;
    px.row[k] = r < 0 ? r + a.m : r;
    px.s[k] = __ldg(a.scale + p * a.scale_stride + k);
  }
  return px;
}

// element e of lane's j-th group of four: j * 128 + lane * 4
template <int K>
__device__ __forceinline__ void load_row(const float* row, int lane, float4 (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = __ldcs(reinterpret_cast<const float4*>(row + j * 128 + lane * 4));
}

__device__ __forceinline__ float blend1(float ts, float tm, float tl, const Pixel& px) {
  return fa(fa(fm(ts, px.s[0]), fm(tm, px.s[1])), fm(tl, px.s[2]));
}

template <int K, typename T>
__device__ __forceinline__ void blend_row(const Args<T>& a, const Pixel& px, int lane,
                                          float4 (&gt)[K]) {
  const T* ts = a.table + static_cast<int64_t>(px.row[0]) * (K * 128);
  const T* tm = a.table + static_cast<int64_t>(px.row[1]) * (K * 128);
  const T* tl = a.table + static_cast<int64_t>(px.row[2]) * (K * 128);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int e = j * 128 + lane * 4;
    const float4 s = load4(ts, e), m = load4(tm, e), l = load4(tl, e);
    gt[j] = make_float4(blend1(s.x, m.x, l.x, px), blend1(s.y, m.y, l.y, px),
                        blend1(s.z, m.z, l.z, px), blend1(s.w, m.w, l.w, px));
  }
}

template <int K>
__device__ __forceinline__ float sum_sq(const float4 (&x)[K]) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) ss += x[j].x * x[j].x + x[j].y * x[j].y + x[j].z * x[j].z + x[j].w * x[j].w;
  return warp_sum(ss);
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads) forward_kernel(Args<T> a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int64_t p = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + r;
    if (p >= a.n) return;
    const Pixel px = load_pixel(a, p);
    float4 x[K];
    load_row<K>(a.x + p * (K * 128), lane, x);
    if (!px.valid) {
      if (lane == 0) a.l1[p] = 0.0f;
      continue;
    }
    float4 gt[K];
    blend_row<K>(a, px, lane, gt);
    const float inv = rsqrtf(fmaxf(sum_sq<K>(x), 1e-24f));
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      acc += fabsf(fs(fm(x[j].x, inv), gt[j].x)) + fabsf(fs(fm(x[j].y, inv), gt[j].y))
           + fabsf(fs(fm(x[j].z, inv), gt[j].z)) + fabsf(fs(fm(x[j].w, inv), gt[j].w));
    }
    acc = warp_sum(acc);
    if (lane == 0) a.l1[p] = fm(acc, a.inv_d);
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads) backward_kernel(Args<T> a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int64_t p = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + r;
    if (p >= a.n) return;
    const Pixel px = load_pixel(a, p);
    float4* dx = reinterpret_cast<float4*>(a.d_x + p * (K * 128));
    if (!px.valid) {
#pragma unroll
      for (int j = 0; j < K; ++j) __stcs(dx + j * 32 + lane, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      if (lane < 3) a.d_scale[p * 3 + lane] = 0.0f;
      continue;
    }
    float4 x[K], sg[K];
    load_row<K>(a.x + p * (K * 128), lane, x);
    blend_row<K>(a, px, lane, sg);  // gt, then its sign against y in place
    const float ss = sum_sq<K>(x);
    const float inv = rsqrtf(fmaxf(ss, 1e-24f));
    float sy = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 y = make_float4(fm(x[j].x, inv), fm(x[j].y, inv), fm(x[j].z, inv),
                                   fm(x[j].w, inv));
      sg[j] = make_float4(sgn(fs(y.x, sg[j].x)), sgn(fs(y.y, sg[j].y)), sgn(fs(y.z, sg[j].z)),
                          sgn(fs(y.w, sg[j].w)));
      sy += sg[j].x * y.x + sg[j].y * y.y + sg[j].z * y.z + sg[j].w * y.w;
    }
    // <sgn, T[id_k]>: the rows again, from L1
    float dk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* t = a.table + static_cast<int64_t>(px.row[k]) * (K * 128);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 v = load4(t, j * 128 + lane * 4);
        acc += sg[j].x * v.x + sg[j].y * v.y + sg[j].z * v.z + sg[j].w * v.w;
      }
      dk[k] = warp_sum(acc);
    }
    sy = ss >= 1e-24f ? warp_sum(sy) : 0.0f;
    const float gm = __fdiv_rn(__ldg(a.g + p), a.d);
    const float c = inv * gm;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float yx = x[j].x * inv, yy = x[j].y * inv, yz = x[j].z * inv, yw = x[j].w * inv;
      __stcs(dx + j * 32 + lane,
             make_float4(c * (sg[j].x - yx * sy), c * (sg[j].y - yy * sy),
                         c * (sg[j].z - yz * sy), c * (sg[j].w - yw * sy)));
    }
    if (lane < 3) a.d_scale[p * 3 + lane] = -(lane == 0 ? dk[0] : lane == 1 ? dk[1] : dk[2]) * gm;
  }
}

template <typename T>
Args<T> make_args(const float* x, const void* table, int m, int d, const int* ids,
                  int64_t ids_stride, const float* scale, int64_t scale_stride, int64_t n) {
  Args<T> a{};
  a.x = x;
  a.table = static_cast<const T*>(table);
  a.ids = ids;
  a.scale = scale;
  a.n = n;
  a.ids_stride = ids_stride;
  a.scale_stride = scale_stride;
  a.m = m;
  a.inv_d = 1.0f / static_cast<float>(d);
  a.d = static_cast<float>(d);
  return a;
}

template <bool Backward, typename T>
int launch(Args<T> a, int d, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (a.n == 0) return 0;
  switch (d) {
#define GAGS_J6_CASE(K)                                                             \
  case K * 128:                                                                     \
    if (Backward) backward_kernel<K, T><<<blocks, kThreads, 0, stream>>>(a);        \
    else forward_kernel<K, T><<<blocks, kThreads, 0, stream>>>(a);                  \
    break;
    GAGS_J6_CASE(1)
    GAGS_J6_CASE(2)
    GAGS_J6_CASE(4)
    GAGS_J6_CASE(6)
    GAGS_J6_CASE(8)
#undef GAGS_J6_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, d) float32 rows; table (m, d), float16 where table_half, else
// float32; ids (n, 3) int32 and scale (n, 3) float32 with row strides in
// elements; d one of 128, 256, 512, 768, 1024. Writes l1 (n,).
int gags_supervision_forward(const float* x, const void* table, int table_half, int m, int d,
                             const int* ids, int64_t ids_stride, const float* scale,
                             int64_t scale_stride, int64_t n, float* l1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_half) {
    auto a = make_args<__half>(x, table, m, d, ids, ids_stride, scale, scale_stride, n);
    a.l1 = l1;
    return launch<false>(a, d, s);
  }
  auto a = make_args<float>(x, table, m, d, ids, ids_stride, scale, scale_stride, n);
  a.l1 = l1;
  return launch<false>(a, d, s);
}

// The same inputs and g (n,) float32, the loss's gradient per pixel.
// Writes d_x (n, d) and d_scale (n, 3), both contiguous.
int gags_supervision_backward(const float* x, const void* table, int table_half, int m, int d,
                              const int* ids, int64_t ids_stride, const float* scale,
                              int64_t scale_stride, int64_t n, const float* g, float* d_x,
                              float* d_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_half) {
    auto a = make_args<__half>(x, table, m, d, ids, ids_stride, scale, scale_stride, n);
    a.g = g;
    a.d_x = d_x;
    a.d_scale = d_scale;
    return launch<true>(a, d, s);
  }
  auto a = make_args<float>(x, table, m, d, ids, ids_stride, scale, scale_stride, n);
  a.g = g;
  a.d_x = d_x;
  a.d_scale = d_scale;
  return launch<true>(a, d, s);
}

}  // extern "C"
