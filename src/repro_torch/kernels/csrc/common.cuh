// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Keys arrive in the port's carrier: the bit pattern of the reference's
// unsigned ordered key, stored in a signed torch dtype.  Every kernel reads
// it as the unsigned type of the same width, so digits and compares here are
// plain unsigned arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_ERROR_STRING                                                    \
  extern "C" const char* repro_error_string(int e) {                         \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                   \
  }

constexpr unsigned kFullMask = 0xffffffffu;

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, int lo, int width) {
  return static_cast<unsigned>((key >> lo) & ((K(1) << width) - K(1)));
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// Warp-aggregated increment: lanes whose `bin` is >= 0 add 1 to
// counter[bin]; lanes with equal bins are merged first so a skewed warp
// issues one atomic per distinct bin instead of 32 to one address (the
// paper's Fig. 2 thread reduction).  Every lane of the warp must call it.
__device__ __forceinline__ void warp_count(int* counter, int bin, int lane) {
  unsigned want = __ballot_sync(kFullMask, bin >= 0);
  if (bin >= 0) {
    unsigned peers = __match_any_sync(want, bin);
    if (lane == __ffs(peers) - 1) atomicAdd(counter + bin, __popc(peers));
  }
}

// Dispatch a key width in bytes to the unsigned key type.
#define REPRO_DISPATCH_KEY(bytes, K, ...)                                     \
  switch (bytes) {                                                            \
    case 1: { using K = uint8_t; __VA_ARGS__; } break;                        \
    case 2: { using K = uint16_t; __VA_ARGS__; } break;                       \
    case 4: { using K = uint32_t; __VA_ARGS__; } break;                       \
    case 8: { using K = unsigned long long; __VA_ARGS__; } break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }
