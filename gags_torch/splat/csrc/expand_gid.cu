// expand_gid: owning depth rank of every instance slot.
//
// Replaces the TPU kernel gags_tpu/splat/pallas_kernel.py:expand_gid
// (body _expand_gid_kernel), which recovers, for the ragged->dense instance
// expansion of the unaligned binning, the rank that owns each slot:
//
//     gid[i] = clip(#{j < n : offsets[j] <= i} - 1, 0, n - 1),  i < num_slots
//
// where `offsets` is the monotone exclusive cumsum of per-rank instance
// counts in depth-rank order.
//
// What bounds it on the H100: bytes, by the bound's count (4 B written a
// slot, `offsets` read once: 1.5 us at the serve shape). What held the
// first design back was latency: one thread per slot ran its own upper-
// bound binary search over `offsets` in global memory, ~18-20 dependent
// L2 round trips a thread, over ~4 waves of 256-thread blocks.
//
// Design: owner_window.cuh, one search per tile of 1024 slots instead of
// one per slot. Warps 0 and 1 find the tile's first and last owner (32-way
// searches, 4 dependent loads each), the ranks between them mark their
// first slots in shared memory (one pass of 16-byte loads), and a block
// prefix maximum of the marks gives every slot its owner. A thread holds
// 4 consecutive slots and stores them as one int4. The grid is one
// wave (as many blocks as fit on the SMs at once), each block looping
// over tiles. Exact on any monotone offsets: slots below offsets[0] are
// rank 0's, a tile at or past offsets[n - 1] is rank n - 1's without a
// search, and a run of empty ranks is read like any other, its shared
// offset marked by its last rank (owner_window.cuh).

#include <cuda_runtime.h>

#include "owner_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // slots a thread a round: one int4 store
constexpr int kRounds = 1;
constexpr int kTile = kThreads * kVec * kRounds;  // 1024 slots

__global__ void __launch_bounds__(kThreads)
expand_gid_kernel(const int* __restrict__ offsets, int n, int* __restrict__ gid, int num_slots,
                  int num_tiles) {
  __shared__ __align__(16) int mark[kTile];
  __shared__ int wtot[kThreads / 32];
  __shared__ int plan[2];
  const int offl = __ldg(offsets + n - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int s0 = t * kTile, s1 = min(s0 + kTile, num_slots);
    int own[kVec * kRounds];
    owner::tile_owners<kThreads, kVec, kRounds, 0>(offsets, nullptr, n, offl, s0, s1, mark,
                                                    wtot, plan, nullptr, nullptr, own);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int base = s0 + owner::slot_of<kVec, kRounds>(warp, lane, r, 0);
      if (base + kVec <= s1) {
        *reinterpret_cast<int4*>(gid + base) =
            make_int4(own[r * kVec], own[r * kVec + 1], own[r * kVec + 2], own[r * kVec + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if (base + v < s1) gid[base + v] = own[r * kVec + v];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* gags_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// offsets: (n,) int32 on the device, on 16 bytes; gid: (num_slots,) int32
// output on 16 bytes. Launches on `stream` and returns the first CUDA
// error of sizing the grid or of the launch.
int gags_expand_gid(const void* offsets, int n, void* gid, int num_slots, void* stream) {
  if (num_slots <= 0) return 0;
  const int tiles = (num_slots + kTile - 1) / kTile;
  int blocks = 0;
  const int err = owner::wave_blocks(expand_gid_kernel, kThreads, tiles, &blocks);
  if (err != 0) return err;
  expand_gid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), n, static_cast<int*>(gid), num_slots, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
