// sorted_segment_sum (K3): per-rank sums of the per-instance gradient rows
// over the rank-sorted ReductionLayout (gags_torch/splat/tiles.py).
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:
// sorted_segment_sum (body _segsum_kernel). Same contract:
//   out[b * chunk + r, c] = sum of rows[slot_to_pos[s], c] over the slots s
//   of the chunks with chunk_block == b and slot_rank[s] == r,
// where padding slots carry slot_rank = -1 (and slot_to_pos = M, the
// position past the last row). Within one rank block's run of chunks the
// layout lists its slots in ascending rank (a stable sort of the
// instances' ranks), padding last. The kernel gathers the rows through
// slot_to_pos itself: the TPU path's u16 bit-half gather and its
// SEGSUM_SUB grouping are artefacts of its DMA engine.
//
// What bounds it on the H100: bytes in principle (each instance row read
// once through a gather, its slot entries once, each rank's sum written
// once; ~C adds per row); in practice the latency of the dependent loads
// each block waits on. The first design gave each warp one rank at a time:
// two binary searches over the run's slot ranks in device memory, then a
// serial gather with the lanes over channels (16 of 32 lanes busy at
// C = 16, 3 at C = 3): ~7x its bytes bound at C = 16 on the GAD binning
// and slower than one index_add_ (PERF.md section 6 has both designs'
// times, timed in turns on one card).
//
// Design: one 256-thread block per rank block of `chunk` ranks, so every
// output row has one writer and the result does not vary between runs.
//  1. Two warps find the block's run of chunks in chunk_block by a 32-ary
//     search (one ballot per round; three rounds for 3k-17k chunks).
//  2. The block streams the run's slot ranks in coalesced tiles of 256
//     slots: slot s starts rank r where its rank differs from slot s-1's,
//     which gives every rank's [lo, hi) in shared memory without a
//     search; slot_to_pos is staged beside it, so the gathers do not read
//     it from device memory a second time. The stream stops at the first
//     padding slot or rank past num_ranks, so the sentinel rank's filler
//     slots in the last block are never read.
//  3. Threads map over (rank, channel vector) pairs, with 16-byte float4
//     gathers where C % 4 == 0 (four threads per rank at C = 16, two at
//     C = 8; one float per thread otherwise), four gathers in flight per
//     thread, summed in slot order: the same additions in the same order
//     as a serial sum, so ranks of at most kHeavy slots match the first
//     design bit for bit.
//  4. A rank with more than kHeavy slots (a large splat over many tiles)
//     is summed by a whole warp instead: each lane group takes a fixed
//     contiguous share of the slots, and the shares are added in group
//     order, so the result is still fixed by the layout alone.
// Device time per call on the main paths (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W): GAD C = 16, 0.0255 ms against a 0.0138 ms bytes bound;
// RGB C = 3, 0.0175 / 0.0052 ms and C = 8, 0.0224 / 0.0113 ms. Why C = 3
// stays 3.4x its bound is a hypothesis no run has isolated: of the RGB
// path's 400k ranks most hold no slot, yet each of the 3,125 blocks pays
// its chunk_block search and two barriers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2048;  // slot_to_pos entries staged per block
constexpr int kHeavy = 16;    // slots above which a warp sums the rank

template <int VW>
struct alignas(4 * VW) Vec {
  float v[VW];
  __device__ __forceinline__ void add(const Vec& o) {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] += o.v[i];
  }
};

// first index in [0, n) whose value >= v (a non-decreasing), by the whole
// warp: each step splits the range into 32 parts and ballots on them
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n,
                                                int v, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const int below = __popc(__ballot_sync(0xffffffffu, i < hi && a[i] < v));
    const int nlo = below ? lo + (below - 1) * step + 1 : lo;
    hi = min(hi, lo + below * step);
    lo = nlo;
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, i < hi && a[i] < v));
}

// a slot's rank, with padding and ranks at or past `limit` as `limit`
__device__ __forceinline__ int clipped_rank(const int* __restrict__ slot_rank, int s,
                                            int limit) {
  const int r = slot_rank[s];
  return (r < 0 || r > limit) ? limit : r;
}

template <int VW>
struct Gather {
  const Vec<VW>* __restrict__ rows;
  const int* __restrict__ slot_to_pos;
  const int* spos;  // staged slot_to_pos[s0 .. s0 + kStage)
  int s0, nvec;

  __device__ __forceinline__ Vec<VW> row(int s, int v) const {
    const int pos = s - s0 < kStage ? spos[s - s0] : slot_to_pos[s];
    return rows[static_cast<size_t>(pos) * nvec + v];
  }

  // rows[slot_to_pos[s]][v] summed over s in [a, e) in slot order, four
  // gathers issued before their additions
  __device__ __forceinline__ Vec<VW> sum(int a, int e, int v) const {
    Vec<VW> acc = {};
    int s = a;
    for (; s + 4 <= e; s += 4) {
      Vec<VW> x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = row(s + j, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.add(x[j]);
    }
    for (; s < e; ++s) acc.add(row(s, v));
    return acc;
  }
};

template <int VW>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const float* __restrict__ rows,
                          const int* __restrict__ slot_to_pos,
                          const int* __restrict__ slot_rank,
                          const int* __restrict__ chunk_block,
                          float* __restrict__ out, int num_chunks, int chunk,
                          int channels, int num_ranks) {
  extern __shared__ int smem[];
  int* lo = smem;                 // (chunk + 1,) first slot of each rank
  int* spos = smem + chunk + 1;   // (kStage,) staged slot_to_pos
  __shared__ int run[2];
  __shared__ Vec<VW> part[kWarps][32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // 1. the run of chunks of rank block b
  if (warp < 2) {
    const int c = warp_lower_bound(chunk_block, num_chunks, b + warp, lane);
    if (lane == 0) run[warp] = c;
  }
  __syncthreads();
  const int s0 = run[0] * chunk;
  const int s1 = run[1] * chunk;
  const int limit = min(chunk, num_ranks - b * chunk);

  // 2. rank boundaries: lo[r] = first slot of rank >= r, lo[limit] = end
  bool done = false;
  for (int base = s0; base < s1 && !done; base += kThreads) {
    const int s = base + threadIdx.x;
    bool end = false;
    if (s < s1) {
      const int k = clipped_rank(slot_rank, s, limit);
      const int kp = s == s0 ? -1 : clipped_rank(slot_rank, s - 1, limit);
      const int pos = slot_to_pos[s];  // issued beside the rank loads
      for (int r = kp + 1; r <= k; ++r) lo[r] = s;
      if (k < limit && s - s0 < kStage) spos[s - s0] = pos;
      end = k == limit;
    }
    done = __syncthreads_or(end);
  }
  if (!done) {  // every slot of the run holds a rank below limit
    const int kl = s1 > s0 ? clipped_rank(slot_rank, s1 - 1, limit) : -1;
    for (int r = kl + 1 + threadIdx.x; r <= limit; r += kThreads) lo[r] = s1;
  }
  __syncthreads();

  const int nvec = channels / VW;
  const Gather<VW> g{reinterpret_cast<const Vec<VW>*>(rows), slot_to_pos, spos, s0,
                     nvec};
  Vec<VW>* outv = reinterpret_cast<Vec<VW>*>(out) + static_cast<size_t>(b) * chunk * nvec;

  // 3. light ranks: one thread per (rank, vector)
  for (int p = threadIdx.x; p < limit * nvec; p += kThreads) {
    const int r = p / nvec;
    const int v = p - r * nvec;
    const int a = lo[r], e = lo[r + 1];
    if (e - a <= kHeavy) outv[static_cast<size_t>(r) * nvec + v] = g.sum(a, e, v);
  }

  // 4. heavy ranks: one warp per rank, lane groups over contiguous shares
  for (int r = warp; r < limit; r += kWarps) {
    const int a = lo[r], e = lo[r + 1];
    if (e - a <= kHeavy) continue;
    for (int v0 = 0; v0 < nvec; v0 += 32) {
      const int nv = min(32, nvec - v0);
      const int groups = 32 / nv;
      const int grp = lane / nv;
      const int v = v0 + lane - grp * nv;
      if (grp < groups) {
        const int len = e - a;
        part[warp][lane] = g.sum(a + len * grp / groups, a + len * (grp + 1) / groups, v);
      }
      __syncwarp();
      if (lane < nv) {
        Vec<VW> acc = {};
        for (int q = 0; q < groups; ++q) acc.add(part[warp][q * nv + lane]);
        outv[static_cast<size_t>(r) * nvec + v] = acc;
      }
      __syncwarp();
    }
  }
}

template <int VW>
int launch(const void* rows, const void* slot_to_pos, const void* slot_rank,
           const void* chunk_block, void* out, int num_chunks, int chunk,
           int channels, int num_ranks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk + 1 + kStage) * sizeof(int);
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted_segment_sum_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (num_ranks + chunk - 1) / chunk;
  sorted_segment_sum_kernel<VW><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(rows), static_cast<const int*>(slot_to_pos),
      static_cast<const int*>(slot_rank), static_cast<const int*>(chunk_block),
      static_cast<float*>(out), num_chunks, chunk, channels, num_ranks);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows (M, C) f32, slot_to_pos and slot_rank (num_chunks * chunk,) i32,
// chunk_block (num_chunks,) i32 non-decreasing, out (num_ranks, C) f32
// (every row written). Launches on `stream`; returns cudaGetLastError().
int gags_sorted_segment_sum(const void* rows, const void* slot_to_pos,
                            const void* slot_rank, const void* chunk_block,
                            void* out, int num_chunks, int chunk, int channels,
                            int num_ranks, void* stream) {
  if (num_ranks <= 0 || channels <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (channels % 4 == 0 && aligned(rows, 16) && aligned(out, 16))
    return launch<4>(rows, slot_to_pos, slot_rank, chunk_block, out, num_chunks,
                     chunk, channels, num_ranks, s);
  return launch<1>(rows, slot_to_pos, slot_rank, chunk_block, out, num_chunks, chunk,
                   channels, num_ranks, s);
}

}  // extern "C"
