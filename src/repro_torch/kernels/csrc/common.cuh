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
// sign fill, as XLA's shifts do.  width <= 16.
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

// One warp step of a stable rank through per-warp digit bitmasks (the
// fused pass's and the local sort's; CUB's onesweep does the same): the
// lanes of one digit find each other through the warp's zeroed table of
// digit bitmasks (one shared atomicOr each, then one read), read the
// warp's running count of their digit, and their lowest lane bumps it and
// clears the mask.  Returns each valid lane's rank among the warp's keys of
// its digit so far: the earlier steps, then the lower lanes of this one.
// Every lane of the warp calls it; `C` is the counter type.
template <typename C>
__device__ __forceinline__ int warp_mask_rank(C* mine, unsigned* masks,
                                              unsigned d, bool valid,
                                              int lane) {
  if (valid) atomicOr(masks + d, 1u << lane);
  __syncwarp();
  const unsigned peers = valid ? masks[d] : 0u;
  const int before = valid ? static_cast<int>(mine[d]) : 0;
  __syncwarp();
  if (valid && lane == __ffs(peers) - 1) {
    mine[d] = static_cast<C>(before + __popc(peers));
    masks[d] = 0;
  }
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

// keys[0, count) of a row into shared memory by the whole block, 16 bytes
// per load where the row's keys reach a 16-byte boundary (a scalar head and
// tail around them).
template <typename K>
__device__ void load_row(const K* __restrict__ src, int count, K* sk) {
  constexpr int V = 16 / sizeof(K);
  const int head = min(
      count, static_cast<int>(
                 ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
                 sizeof(K)));
  const int nvec = (count - head) / V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  if (threadIdx.x < head) sk[threadIdx.x] = src[threadIdx.x];
  if (head == 0) {
    uint4* vdst = reinterpret_cast<uint4*>(sk);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x)
      vdst[v] = __ldcs(vsrc + v);
  } else {
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      KeyVec<K> a;
      a.v = __ldcs(vsrc + v);
#pragma unroll
      for (int e = 0; e < V; ++e) sk[head + v * V + e] = a.k[e];
    }
  }
  for (int i = head + nvec * V + threadIdx.x; i < count; i += blockDim.x)
    sk[i] = src[i];
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

// Asks L2 for the whole 16-byte units of bytes [begin, end).
__device__ __forceinline__ void prefetch_l2(const void* base, long long begin,
                                            long long end) {
  begin = (begin + 15) / 16 * 16;
  end = end / 16 * 16;
  if (end > begin)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                     static_cast<const unsigned char*>(base) + begin),
                 "r"(static_cast<unsigned>(end - begin))
                 : "memory");
}
