// owner_window.cuh: the owner search that K6 (expand_gid.cu) and K7
// (expand_keys.cu) share.
//
// Both give every instance slot i its owning depth rank
//
//     owner(i) = clip(#{j < n : off[j] <= i} - 1, 0, n - 1)
//              = max(0, the largest j with off[j] <= i)
//
// for monotone int32 per-rank offsets `off`. A block owns a tile of
// kSlots consecutive slots [s0, s1). Each warp owns a run of 32 kVec
// kRounds of them, and in round r its lanes own 32 kVec consecutive
// slots, kVec a lane (slot_of below), so that a lane's slots of one round
// are one 16-byte store and a warp's stores of a round are one run.
//
// A tile at or past off[n - 1] is rank n - 1's, without a search (the
// empty tail of ranks that cover no tile, and the fillers past the last
// instance). Otherwise, one search per tile, not one per slot:
//   1. warp 0 finds g0, the last rank with off <= s0 (-1 if none), and
//      warp 1 gl, the last with off <= min(s1, off[n - 1]) - 1, each by a
//      32-way search over `off` in global memory (4 dependent loads for
//      ~1M ranks where a binary search takes 20);
//   2. the ranks g0 + 1 .. gl are read once, by 16-byte loads, and each
//      marks its first slot in shared memory: mark[off[g] - s0] = g (an
//      atomicMax, so that of a run of empty ranks at one offset the last
//      wins, as the upper bound does), and mark[0] = g0;
//   3. a slot's owner is the prefix maximum of the marks up to it (a
//      lane's run, its warp's rounds by shuffle scans carried from round
//      to round, the warps before it through shared memory), clipped to
//      0 below off[0] and n - 1 at or past off[n - 1].
// Runs of empty ranks need no window logic: they are read in step 2 like
// any rank (each rank by the one or two tiles its offset falls in), and
// the atomicMax resolves their shared offset. K7 keeps the offsets and
// packed rects of the first kWindow ranks from g0 in shared memory for
// its keys; an owner past them is read from global memory.
//
// `off` (and K7's `packed`) must start on 16 bytes (the wrappers copy a
// table that does not).

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace owner {

// The upper bound of x in off[lo, hi): lo + #{j in [lo, hi) : off[j] <= x}
// for monotone off. All 32 lanes of a warp call it with the same
// arguments and get the same result: each step every lane probes one of
// 32 evenly spaced entries and a ballot counts those <= x, so the range
// shrinks 32-fold a step where a binary search halves it.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ off, int lo, int hi,
                                                int x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    // lane k probes lo + (k + 1) step - 1; the last probe reaches hi - 1
    const long long q = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool le = q < hi && __ldg(off + q) <= x;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    // probes 0 .. c-1 hold (off <= x), probe c does not or lies past hi
    const long long top = lo + static_cast<long long>(c + 1) * step - 1;
    hi = top < hi ? static_cast<int>(top) : hi;
    lo += c * step;
  }
  return lo;
}

// Slot (relative to the tile) of lane `lane` of warp `warp`, round r,
// element v.
template <int kVec, int kRounds>
__device__ __forceinline__ int slot_of(int warp, int lane, int r, int v) {
  return 32 * kVec * (kRounds * warp + r) + kVec * lane + v;
}

// Ranks whose offset and packed rect K7 finds in shared memory:
// off[g] = w[g - a0], packed[g] = wp[g - a0] for g in [a0, hi]; empty
// (hi < a0) where none was kept.
struct Window {
  int a0, hi;
};

// Owners of this thread's kVec * kRounds slots of the tile [s0, s1)
// (slots past s1 get one too; the caller stores none of them). Shared
// memory: mark, kThreads * kVec * kRounds ints on 16 bytes; wtot,
// kThreads / 32 ints; plan, 2 ints; w and wp, kWindow ints on
// 16 bytes each, or null (then `packed` is not read). offl = off[n - 1].
// Every thread of the block calls it with the same tile. A call writes
// mark, wtot and plan only where every thread is past the last read of
// the call before, and w and wp only after its first barrier, so calls
// follow each other without a barrier and the window stays valid until
// the next call.
template <int kThreads, int kVec, int kRounds, int kWindow>
__device__ __forceinline__ Window tile_owners(const int* __restrict__ off,
                                              const int* __restrict__ packed, int n, int offl,
                                              int s0, int s1, int* mark, int* wtot, int* plan,
                                              int* w, int* wp, int (&own)[kVec * kRounds]) {
  constexpr int kSlots = kThreads * kVec * kRounds, kWarps = kThreads / 32;
  static_assert(kVec == 2 || kVec == 4, "a thread's slots of a round are one 16-byte store");
  static_assert(kWindow % 4 == 0, "the window is kept in 16-byte units");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (s0 >= offl) {  // the same in every thread
#pragma unroll
    for (int k = 0; k < kVec * kRounds; ++k) own[k] = n - 1;
    return Window{0, -1};
  }
  // 1. clear the marks; the tile's first and last owner
  for (int k = 4 * threadIdx.x; k < kSlots; k += 4 * kThreads)
    *reinterpret_cast<int4*>(mark + k) = make_int4(-1, -1, -1, -1);
  if (warp == 0) {
    const int g = warp_upper_bound(off, 0, n, s0) - 1;
    if (lane == 0) plan[0] = g;
  } else if (warp == 1) {
    const int g = warp_upper_bound(off, 0, n, min(s1, offl) - 1) - 1;
    if (lane == 0) plan[1] = g;
  }
  __syncthreads();
  const int g0 = plan[0], gl = plan[1];  // -1 <= g0 <= gl <= n - 1
  // 2. every rank g0 < g <= gl marks its first slot, which lies in the
  // tile: off[g] > s0 (g0 is the last rank at or below s0) and
  // off[g] <= min(s1, offl) - 1
  const int a0 = max(g0, 0) & ~3;
  for (int k = 4 * threadIdx.x; a0 + k <= gl; k += 4 * kThreads) {
    const int j = a0 + k;
    int4 o, p = make_int4(0, 0, 0, 0);
    if (j + 3 < n) {
      o = __ldg(reinterpret_cast<const int4*>(off + j));
      if (w != nullptr) p = __ldg(reinterpret_cast<const int4*>(packed + j));
    } else {
      o = make_int4(__ldg(off + j), j + 1 < n ? __ldg(off + j + 1) : INT_MAX,
                    j + 2 < n ? __ldg(off + j + 2) : INT_MAX, INT_MAX);
      if (w != nullptr)
        p = make_int4(__ldg(packed + j), j + 1 < n ? __ldg(packed + j + 1) : 0,
                      j + 2 < n ? __ldg(packed + j + 2) : 0, 0);
    }
    if (w != nullptr && k < kWindow) {
      *reinterpret_cast<int4*>(w + k) = o;
      *reinterpret_cast<int4*>(wp + k) = p;
    }
    if (j > g0 && j <= gl) atomicMax(mark + (o.x - s0), j);
    if (j + 1 > g0 && j + 1 <= gl) atomicMax(mark + (o.y - s0), j + 1);
    if (j + 2 > g0 && j + 2 <= gl) atomicMax(mark + (o.z - s0), j + 2);
    if (j + 3 > g0 && j + 3 <= gl) atomicMax(mark + (o.w - s0), j + 3);
  }
  if (threadIdx.x == 0 && g0 >= 0) atomicMax(mark, g0);
  __syncthreads();
  // 3. prefix maximum in slot order: a lane's run, its warp's rounds (an
  // inclusive scan by shuffles, carried from round to round), then the
  // warps before it
  int carry = -1;  // the largest mark of this warp's earlier rounds
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int base = slot_of<kVec, kRounds>(warp, lane, r, 0);
    if constexpr (kVec == 4) {
      const int4 m = *reinterpret_cast<const int4*>(mark + base);
      own[4 * r] = m.x;
      own[4 * r + 1] = max(m.x, m.y);
      own[4 * r + 2] = max(own[4 * r + 1], m.z);
      own[4 * r + 3] = max(own[4 * r + 2], m.w);
    } else {
      const int2 m = *reinterpret_cast<const int2*>(mark + base);
      own[2 * r] = m.x;
      own[2 * r + 1] = max(m.x, m.y);
    }
    int x = own[kVec * r + kVec - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = max(x, y);
    }
    const int e = __shfl_up_sync(0xffffffffu, x, 1);
    const int before = lane == 0 ? carry : max(carry, e);
#pragma unroll
    for (int v = 0; v < kVec; ++v) own[kVec * r + v] = max(own[kVec * r + v], before);
    carry = max(carry, __shfl_sync(0xffffffffu, x, 31));
  }
  if (lane == 0) wtot[warp] = carry;
  __syncthreads();
  // the largest mark of the warps before: an exclusive scan over lanes
  int y = lane < kWarps ? wtot[lane] : -1;
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const int z = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) y = max(y, z);
  }
  const int ew = __shfl_sync(0xffffffffu, y, warp > 0 ? warp - 1 : 0);
  const int prior = warp > 0 ? ew : -1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int i = s0 + slot_of<kVec, kRounds>(warp, lane, r, v);
      own[r * kVec + v] = i >= offl ? n - 1 : max(max(prior, own[r * kVec + v]), 0);
    }
  }
  return Window{a0, w != nullptr ? min(gl, a0 + kWindow - 1) : -1};
}

// Blocks for one wave of `kernel` (at most `tiles`): as many as fit on
// every SM at once. Returns a CUDA error code, 0 on success.
template <typename Kernel>
inline int wave_blocks(Kernel kernel, int threads, int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int wave = max(1, per_sm * sms);
  *blocks = tiles < wave ? tiles : wave;
  return static_cast<int>(err);
}

}  // namespace owner
