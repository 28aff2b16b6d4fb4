// J1 jpeg_decode: a JPEG file's pixels on the card, as libjpeg-turbo gives
// them (PIL's Image.open(p).convert("RGB")), and the host entropy decoder
// that feeds it.
//
// Replaces no TPU kernel: the JAX package reads every image through PIL on
// the host (gags_tpu/cli/{train_rgb,gas,metrics,visualize_prompts}.py),
// and the card's machine has no PIL. The plain version is
// gags_torch/utils/jpeg.py (`entropy_decode`, `jpeg_pixels_plain`): the
// same integer arithmetic, so the two agree bit for bit.
//
// Two parts:
//  (a) gags_jpeg_entropy_scan, host C++: the Huffman decoding of one scan
//      (baseline, progressive DC first / refine, AC first / refine with
//      EOBRUN and correction bits; jdhuff.c, jdphuff.c) into int16
//      coefficients in natural order. It is serial by nature; in Python it
//      takes seconds an image.
//  (b) gags_jpeg_pixels, two kernels on the card:
//      idct_kernel: dequantise + jidctint.c's ISLOW IDCT (CONST_BITS 13,
//        PASS1_BITS 2, JLONG arithmetic, the masked range-limit table) of
//        every 8x8 block of every component into its sample plane; eight
//        threads a block, a column each in pass 1, a row each in pass 2,
//        the workspace in shared memory;
//      colour_kernel: libjpeg-turbo's upsampling (h2v1 and h2v2 fancy for
//        components wider than 2 samples, h1v2 fancy, box replication
//        otherwise; edge columns and context rows replicated) and
//        jdcolor.c's YCbCr -> RGB (SCALEBITS 16), grey replicated, RGB
//        passed through, one thread a pixel, into (H, W, 3) uint8.
//
// Bound: bytes. Each coefficient is read once (2 B) and each pixel written
// once (3 B); the sample planes between the kernels add their bytes twice.
// A 1280x720 4:2:0 frame is 21,600 blocks: 2.8 MB in, 2.8 MB out, under
// 2 us at 3.35 TB/s. The IDCT is ~500 integer operations a block (64-bit
// products, as libjpeg's JLONG), far from the card's integer rate. This
// first version favours plain code: a thread a pixel in the colour pass,
// 3-byte stores.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GAGS_HD __host__ __device__
#else
#define GAGS_HD
#endif

namespace jpeg {

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                    FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                    FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                    FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

// jdcolor.c's FIX(x) at SCALEBITS 16
constexpr int fix16(double x) { return static_cast<int>(x * 65536 + 0.5); }
constexpr int kCrR = fix16(1.40200), kCbB = fix16(1.77200), kCrG = fix16(0.71414),
              kCbG = fix16(0.34414);

enum Mode { kFull = 0, kH2V1 = 1, kH2V2 = 2, kH1V2 = 3, kBox = 4 };

struct Layout {
  int width, height, colour, ncomp, total_blocks;
  int mode[3], hr[3], vr[3], bw[3], dw[3], dh[3], offset[3];
  int quant[3][64];  // natural order, each wrapped to 16 bits as ISLOW_MULT_TYPE
};

// libjpeg's post-IDCT range_limit table, indexed by the descaled value & 1023
GAGS_HD inline uint8_t range_limit(long long x) {
  const int m = static_cast<int>(x & 1023);
  return static_cast<uint8_t>(m < 128 ? m + 128 : m < 512 ? 255 : m < 896 ? 0 : m - 896);
}

// jidctint.c's 1-D pass: 8 inputs (a column or a row) -> the 8 outputs
// before the descale, in output order
GAGS_HD inline void idct_1d(const long long* x, long long* out) {
  long long z2 = x[2], z3 = x[6];
  long long z1 = (z2 + z3) * FIX_0_541196100;
  const long long tmp2 = z1 + z3 * -FIX_1_847759065;
  const long long tmp3 = z1 + z2 * FIX_0_765366865;
  const long long tmp0 = (x[0] + x[4]) * (1LL << kConstBits);
  const long long tmp1 = (x[0] - x[4]) * (1LL << kConstBits);
  const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  long long z4 = t1 + t3;
  const long long z5 = (z3 + z4) * FIX_1_175875602;
  t0 *= FIX_0_298631336;
  t1 *= FIX_2_053119869;
  t2 *= FIX_3_072711026;
  t3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  out[0] = tmp10 + t3;
  out[1] = tmp11 + t2;
  out[2] = tmp12 + t1;
  out[3] = tmp13 + t0;
  out[4] = tmp13 - t0;
  out[5] = tmp12 - t1;
  out[6] = tmp11 - t2;
  out[7] = tmp10 - t3;
}

GAGS_HD inline int component_of(const Layout& L, int blk) {
  int k = 0;
  while (k + 1 < L.ncomp && blk >= L.offset[k + 1]) ++k;
  return k;
}

// Pass 1, column t of block `blk`: dequantised coefficients -> the int
// workspace column (DESCALE by CONST_BITS - PASS1_BITS, then C's (int))
GAGS_HD inline void idct_pass1(const Layout& L, const int16_t* coef, int blk, int t, int* ws) {
  const int k = component_of(L, blk);
  const int16_t* c = coef + static_cast<long long>(blk) * 64;
  long long in[8], out[8];
  for (int r = 0; r < 8; ++r)
    in[r] = static_cast<long long>(static_cast<int>(c[r * 8 + t]) * L.quant[k][r * 8 + t]);
  idct_1d(in, out);
  constexpr int n = kConstBits - kPass1Bits;
  for (int r = 0; r < 8; ++r)
    ws[r * 8 + t] = static_cast<int>((out[r] + (1LL << (n - 1))) >> n);
}

// Pass 2, row t: the workspace row -> 8 samples (DESCALE by CONST_BITS +
// PASS1_BITS + 3, range_limit), written into the component's plane
GAGS_HD inline void idct_pass2(const Layout& L, int blk, int t, const int* ws, uint8_t* samples) {
  const int k = component_of(L, blk);
  long long in[8], out[8];
  for (int c = 0; c < 8; ++c) in[c] = ws[t * 8 + c];
  idct_1d(in, out);
  constexpr int n = kConstBits + kPass1Bits + 3;
  const int idx = blk - L.offset[k];
  const int br = idx / L.bw[k], bc = idx % L.bw[k];
  const long long stride = static_cast<long long>(L.bw[k]) * 8;
  uint8_t* row = samples + static_cast<long long>(L.offset[k]) * 64 + (br * 8LL + t) * stride + bc * 8;
  for (int c = 0; c < 8; ++c) row[c] = range_limit((out[c] + (1LL << (n - 1))) >> n);
}

GAGS_HD inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// The upsampled sample of component k at pixel (y, x) (jdsample.c)
GAGS_HD inline int upsampled(const Layout& L, const uint8_t* samples, int k, int y, int x) {
  const uint8_t* p = samples + static_cast<long long>(L.offset[k]) * 64;
  const long long stride = static_cast<long long>(L.bw[k]) * 8;
  const int dw = L.dw[k], dh = L.dh[k];
  auto at = [&](int r, int c) { return static_cast<int>(p[r * stride + c]); };
  switch (L.mode[k]) {
    case kFull:
      return at(y, x);
    case kH2V1: {
      const int ix = x >> 1, nx = clampi((x & 1) ? ix + 1 : ix - 1, 0, dw - 1);
      return (3 * at(y, ix) + at(y, nx) + ((x & 1) ? 2 : 1)) >> 2;
    }
    case kH1V2: {
      const int iy = y >> 1, ny = clampi((y & 1) ? iy + 1 : iy - 1, 0, dh - 1);
      return (3 * at(iy, x) + at(ny, x) + ((y & 1) ? 2 : 1)) >> 2;
    }
    case kH2V2: {
      const int iy = y >> 1, ny = clampi((y & 1) ? iy + 1 : iy - 1, 0, dh - 1);
      const int ix = x >> 1, nx = clampi((x & 1) ? ix + 1 : ix - 1, 0, dw - 1);
      const int near = 3 * at(iy, ix) + at(ny, ix);
      const int far = 3 * at(iy, nx) + at(ny, nx);
      return (3 * near + far + ((x & 1) ? 7 : 8)) >> 4;
    }
    default:
      return at(y / L.vr[k], x / L.hr[k]);
  }
}

// jdcolor.c: one pixel's RGB from its upsampled components
GAGS_HD inline void colour_pixel(const Layout& L, const uint8_t* samples, int y, int x,
                                 uint8_t* rgb) {
  const int c0 = upsampled(L, samples, 0, y, x);
  if (L.colour == 0) {
    rgb[0] = rgb[1] = rgb[2] = static_cast<uint8_t>(c0);
    return;
  }
  const int c1 = upsampled(L, samples, 1, y, x), c2 = upsampled(L, samples, 2, y, x);
  if (L.colour == 2) {
    rgb[0] = static_cast<uint8_t>(c0);
    rgb[1] = static_cast<uint8_t>(c1);
    rgb[2] = static_cast<uint8_t>(c2);
    return;
  }
  const int cb = c1 - 128, cr = c2 - 128;
  const int r = c0 + ((kCrR * cr + (1 << 15)) >> 16);
  const int g = c0 + ((-kCbG * cb + (1 << 15) - kCrG * cr) >> 16);
  const int b = c0 + ((kCbB * cb + (1 << 15)) >> 16);
  rgb[0] = static_cast<uint8_t>(clampi(r, 0, 255));
  rgb[1] = static_cast<uint8_t>(clampi(g, 0, 255));
  rgb[2] = static_cast<uint8_t>(clampi(b, 0, 255));
}

// The int32 parameter block of utils/jpeg.py's JpegFile.layout() -> Layout;
// false if it names what the kernels do not take
inline bool make_layout(const int32_t* p, Layout* L) {
  std::memset(L, 0, sizeof(Layout));
  L->width = p[0];
  L->height = p[1];
  L->colour = p[2];
  L->ncomp = p[3];
  const int max_h = p[4], max_v = p[5];
  if (L->ncomp != 1 && L->ncomp != 3) return false;
  if (L->colour < 0 || L->colour > 2 || (L->colour == 0) != (L->ncomp == 1)) return false;
  for (int k = 0; k < L->ncomp; ++k) {
    const int32_t* c = p + 6 + 7 * k;
    const int h = c[0], v = c[1], dw = c[4], dh = c[5];
    if (h < 1 || v < 1 || max_h % h || max_v % v) return false;
    const int hr = max_h / h, vr = max_v / v;
    L->hr[k] = hr;
    L->vr[k] = vr;
    L->bw[k] = c[2];
    L->dw[k] = dw;
    L->dh[k] = dh;
    L->offset[k] = c[6];
    L->total_blocks = c[6] + c[2] * c[3];
    if (hr == 1 && vr == 1) L->mode[k] = kFull;
    else if (hr == 2 && vr == 1 && dw > 2) L->mode[k] = kH2V1;
    else if (hr == 1 && vr == 2) L->mode[k] = kH1V2;
    else if (hr == 2 && vr == 2 && dw > 2) L->mode[k] = kH2V2;
    else L->mode[k] = kBox;
    const int32_t* q = p + 6 + 7 * L->ncomp + 64 * k;
    for (int i = 0; i < 64; ++i) L->quant[k][i] = static_cast<int16_t>(q[i]);
  }
  return L->width > 0 && L->height > 0;
}

// ---------------------------------------------------------------------------
// (a) host entropy decoding
// ---------------------------------------------------------------------------

constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Bits of one restart interval, most significant first; past its end the
// reader sees zero bits, as libjpeg inserts zeros there
struct BitReader {
  const uint8_t* data;
  long long pos, end, used = 0;
  uint64_t buf = 0;
  int cnt = 0;
  void fill() {
    while (cnt <= 56) {
      const uint64_t b = pos < end ? data[pos] : 0;
      ++pos;
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek16() {
    if (cnt < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
    used += n;
  }
  // n bits as an unsigned number; n is at most 16 (a DC size above 15
  // is refused before it gets here)
  int get(int n) {
    if (n <= 0 || n > 16) return 0;
    if (cnt < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    skip(n);
    return v;
  }
};

// 16-bit lookahead: (code length << 8) | symbol, 0 where no code starts
struct Huffman {
  std::vector<uint16_t> lut;
  explicit Huffman(const uint8_t* t) : lut(1 << 16, 0) {
    int code = 0, k = 16;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < t[len - 1]; ++i, ++k, ++code) {
        const int lo = code << (16 - len), hi = (code + 1) << (16 - len);
        for (int j = lo; j < hi && j < (1 << 16); ++j)
          lut[j] = static_cast<uint16_t>((len << 8) | t[k]);
      }
      code <<= 1;
    }
  }
  // the next symbol, or -1 for a bad code
  int decode(BitReader& br) const {
    const uint16_t e = lut[br.peek16()];
    if (!e) return -1;
    br.skip(e >> 8);
    return e & 255;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + 1 - (1 << s) : v; }

struct Scan {
  int ncomp, per_mcu, progressive, ss, se, ah, al;
  const int32_t* owner;
  const Huffman* dc[4];
  const Huffman* ac[4];
};

// One restart interval: returns 0, or 1 for a bad Huffman code
int decode_interval(const Scan& s, BitReader& br, const int32_t* blocks, int n_mcu,
                    int16_t* coef) {
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
  for (int m = 0; m < n_mcu; ++m) {
    for (int j = 0; j < s.per_mcu; ++j) {
      int16_t* b = coef + static_cast<long long>(blocks[m * s.per_mcu + j]) * 64;
      const int k = s.owner[j];
      if (!s.progressive || s.ss == 0) {  // DC (baseline or progressive)
        if (s.progressive && s.ah) {
          if (br.get(1)) b[0] = static_cast<int16_t>(b[0] | p1);
        } else {
          const int t = s.dc[k]->decode(br);
          if (t < 0 || t > 15) return 1;
          const int diff = t ? extend(br.get(t), t) : 0;
          pred[k] += diff;
          b[0] = static_cast<int16_t>(s.progressive ? pred[k] * (1 << s.al) : pred[k]);
        }
        if (s.progressive) continue;
        for (int i = 1; i < 64; ++i) {  // baseline AC
          const int rs = s.ac[k]->decode(br);
          if (rs < 0) return 1;
          const int r = rs >> 4, z = rs & 15;
          if (z) {
            i += r;
            b[kNatural[i]] = static_cast<int16_t>(extend(br.get(z), z));
          } else {
            if (r != 15) break;
            i += 15;
          }
        }
        continue;
      }
      if (s.ah == 0) {  // AC first
        if (eobrun) {
          --eobrun;
          continue;
        }
        for (int i = s.ss; i <= s.se; ++i) {
          const int rs = s.ac[0]->decode(br);
          if (rs < 0) return 1;
          const int r = rs >> 4, z = rs & 15;
          if (z) {
            i += r;
            b[kNatural[i]] = static_cast<int16_t>(extend(br.get(z), z) * (1 << s.al));
          } else if (r == 15) {
            i += 15;
          } else {
            eobrun = (1 << r) + br.get(r) - 1;
            break;
          }
        }
        continue;
      }
      // AC refine
      int i = s.ss;
      if (eobrun == 0) {
        for (; i <= s.se; ++i) {
          const int rs = s.ac[0]->decode(br);
          if (rs < 0) return 1;
          int r = rs >> 4, z = rs & 15;
          if (z) {
            z = br.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = (1 << r) + br.get(r);
            break;
          }
          do {  // nonzero coefficients get a correction bit; r zero ones pass
            int16_t* c = b + kNatural[i];
            if (*c != 0) {
              if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
            } else if (--r < 0) {
              break;
            }
            ++i;
          } while (i <= s.se);
          if (z) b[kNatural[i]] = static_cast<int16_t>(z);
        }
      }
      if (eobrun > 0) {
        for (; i <= s.se; ++i) {
          int16_t* c = b + kNatural[i];
          if (*c != 0 && br.get(1) && (*c & p1) == 0)
            *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
        }
        --eobrun;
      }
    }
  }
  return 0;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// (b) the kernels
// ---------------------------------------------------------------------------

constexpr int kIdctThreads = 256;  // 32 blocks of 8 threads
constexpr int kColourThreads = 256;

__global__ void __launch_bounds__(kIdctThreads)
idct_kernel(const int16_t* __restrict__ coef, uint8_t* __restrict__ samples, const Layout L) {
  __shared__ int ws[kIdctThreads / 8][64];
  const int g = threadIdx.x >> 3, t = threadIdx.x & 7;
  const int blk = blockIdx.x * (kIdctThreads / 8) + g;
  const bool live = blk < L.total_blocks;
  if (live) idct_pass1(L, coef, blk, t, ws[g]);
  __syncwarp();  // a block's eight threads share a warp
  if (live) idct_pass2(L, blk, t, ws[g], samples);
}

__global__ void __launch_bounds__(kColourThreads)
colour_kernel(const uint8_t* __restrict__ samples, uint8_t* __restrict__ out, const Layout L) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(L.width) * L.height) return;
  const int y = static_cast<int>(i / L.width), x = static_cast<int>(i % L.width);
  colour_pixel(L, samples, y, x, out + i * 3);
}
#endif

}  // namespace jpeg

extern "C" {

// data: the scan's unstuffed restart intervals back to back (seg_offsets,
// n_seg + 1 entries), 8 zero bytes after the last; params: ncomp, blocks
// an MCU, MCUs, MCUs an interval, progressive, Ss, Se, Ah, Al, then the
// scan component of each block of an MCU; tables: (2, 4, 272) DC then AC
// Huffman tables (16 counts, 256 symbols) of each scan component; blocks:
// (MCUs, blocks an MCU) coefficient blocks. Returns 0, 1 for a bad
// Huffman code, 2 when an interval reads past its data.
int gags_jpeg_entropy_scan(const uint8_t* data, const long long* seg_offsets, int n_seg,
                           const int32_t* params, const uint8_t* tables, const int32_t* blocks,
                           int16_t* coef) {
  jpeg::Scan s;
  s.ncomp = params[0];
  s.per_mcu = params[1];
  const int n_mcu = params[2], per_seg = params[3];
  s.progressive = params[4];
  s.ss = params[5];
  s.se = params[6];
  s.ah = params[7];
  s.al = params[8];
  s.owner = params + 9;
  std::vector<jpeg::Huffman> huff;
  huff.reserve(8);
  for (int cls = 0; cls < 2; ++cls) {
    for (int k = 0; k < 4; ++k) {
      const uint8_t* t = tables + (cls * 4 + k) * 272;
      huff.emplace_back(t);
      (cls ? s.ac : s.dc)[k] = &huff.back();
    }
  }
  for (int g = 0; g < n_seg; ++g) {
    jpeg::BitReader br{data, seg_offsets[g], seg_offsets[g + 1]};
    const int first = g * per_seg;
    const int count = n_mcu - first < per_seg ? n_mcu - first : per_seg;
    if (jpeg::decode_interval(s, br, blocks + static_cast<long long>(first) * s.per_mcu, count,
                              coef))
      return 1;
    if (br.used > 8 * (seg_offsets[g + 1] - seg_offsets[g])) return 2;
  }
  return 0;
}

#ifdef __CUDACC__
const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// coef: (blocks, 64) int16 on the device; layout: the host parameter block
// of JpegFile.layout(); samples: blocks * 64 bytes of device scratch; out:
// (H, W, 3) uint8 on the device. Launches both kernels on `stream`; returns
// the first CUDA error (cudaErrorInvalidValue for a layout it does not take).
int gags_jpeg_pixels(const void* coef, const int32_t* layout, void* samples, void* out,
                     void* stream) {
  jpeg::Layout L;
  if (!jpeg::make_layout(layout, &L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = jpeg::kIdctThreads / 8;
  jpeg::idct_kernel<<<(L.total_blocks + per - 1) / per, jpeg::kIdctThreads, 0, st>>>(
      static_cast<const int16_t*>(coef), static_cast<uint8_t*>(samples), L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pixels = static_cast<long long>(L.width) * L.height;
  jpeg::colour_kernel<<<static_cast<unsigned>((pixels + jpeg::kColourThreads - 1) /
                                              jpeg::kColourThreads),
                        jpeg::kColourThreads, 0, st>>>(static_cast<const uint8_t*>(samples),
                                                       static_cast<uint8_t*>(out), L);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
