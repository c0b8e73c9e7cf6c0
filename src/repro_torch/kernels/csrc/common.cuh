// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Keys arrive in the port's carrier: the bit pattern of the reference's
// unsigned ordered key, stored in a signed torch dtype.  Every kernel reads
// it as the unsigned type of the same width, so digits and compares here are
// plain unsigned arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define REPRO_ERROR_STRING                                                    \
  extern "C" const char* repro_error_string(int e) {                         \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                   \
  }

constexpr unsigned kFullMask = 0xffffffffu;

// The digit (key >> lo) & (2^width - 1) with the key dtype's own shift:
// logical for an unsigned key, arithmetic for a signed one (the bits read
// as the unsigned K either way).  A shift past the top bit gives 0 or the
// sign fill, as XLA's shifts do.  width <= 8.
template <typename K>
__device__ __forceinline__ unsigned digit_at(K key, int lo, int width,
                                             bool logical) {
  using S = typename std::make_signed<K>::type;
  constexpr int kBits = sizeof(K) * 8;
  K shifted;
  if (logical)
    shifted = lo >= kBits ? K(0) : K(key >> lo);
  else
    shifted = K(static_cast<S>(key) >> (lo >= kBits ? kBits - 1 : lo));
  return static_cast<unsigned>(shifted) & ((1u << width) - 1u);
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// Stable in-block digit ranks, the counting sort of one tile.  The block's
// keys [0, count) are cut into one contiguous slice per warp
// (warp_slice_per), each walked 32 keys at a time in index order, twice:
//   1. warp_count_step adds each step's digits to the warp's row of a
//      zeroed (warps, r) shared table;
//   2. warps_exclusive turns the table into exclusive offsets across the
//      warps, per digit, and writes the block's histogram;
//   3. warp_rank_step, per step of the second walk, returns each lane's
//      rank among the block's keys of its digit: the keys of earlier warps
//      and earlier steps, plus the lower lanes of this step with the same
//      digit (__match_any_sync).  So equal digits keep their index order.
// Every lane of the warp calls the step functions; the caller syncs the
// block between the walks.
__device__ __forceinline__ int warp_slice_per(int count, int warps) {
  return ((count + warps - 1) / warps + 31) / 32 * 32;
}

__device__ __forceinline__ void warp_count_step(int* mine, unsigned d,
                                                bool valid, int lane) {
  const unsigned want = __ballot_sync(kFullMask, valid);
  if (valid) {
    const unsigned peers = __match_any_sync(want, d);
    if (lane == __ffs(peers) - 1) mine[d] += __popc(peers);
  }
  __syncwarp();
}

__device__ __forceinline__ void warps_exclusive(int* wcnt, int warps, int r,
                                                int* total) {
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = wcnt[w * r + d];
      wcnt[w * r + d] = run;
      run += c;
    }
    total[d] = run;
  }
}

__device__ __forceinline__ int warp_rank_step(int* mine, unsigned d,
                                              bool valid, int lane) {
  const unsigned want = __ballot_sync(kFullMask, valid);
  unsigned peers = 0;
  int before = 0;
  if (valid) {
    peers = __match_any_sync(want, d);
    before = mine[d];
  }
  __syncwarp();
  if (valid && lane == __ffs(peers) - 1) mine[d] = before + __popc(peers);
  __syncwarp();
  return before + __popc(peers & lanemask_lt(lane));
}

// One 16-byte vector load seen as keys: 4 uint32, 2 uint64, 8 uint16 or 16
// uint8.
template <typename K>
union KeyVec {
  uint4 v;
  K k[16 / sizeof(K)];
};

// Dispatch a key width in bytes to the unsigned key type.
#define REPRO_DISPATCH_KEY(bytes, K, ...)                                     \
  switch (bytes) {                                                            \
    case 1: { using K = uint8_t; __VA_ARGS__; } break;                        \
    case 2: { using K = uint16_t; __VA_ARGS__; } break;                       \
    case 4: { using K = uint32_t; __VA_ARGS__; } break;                       \
    case 8: { using K = unsigned long long; __VA_ARGS__; } break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }
