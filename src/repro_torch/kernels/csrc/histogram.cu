// Digit histograms: the port of repro/kernels/histogram.py::_hist_kernel
// and of repro/kernels/assigned.py::_assigned_hist_kernel.
//
// Replaces: the TPU kernels formed a one-hot (KPB, r) matrix per tile and
// contracted it with ones on the MXU.  Here each CTA counts the digits of
// its key range into per-warp sub-histograms in shared memory, merging the
// lanes of a warp that hold the same digit first (__match_any_sync, the
// paper's Fig. 2 thread reduction), so an all-equal tile costs one shared
// atomic per warp step instead of 32 on one address.  The per-warp rows are
// summed per CTA.  Three ways out:
//   * rows:     one CTA per tile stores its (r,) row (radix_histogram);
//   * total:    a few thousand CTAs over the whole array add into one (r,)
//               total with one global atomic per bin (the main path's
//               prologue);
//   * assigned: CTA g reads its own descriptor (tile_idx[g], valid[g]) from
//               global memory, counts that tile and stores the row times
//               valid[g] (assigned_histogram).  This takes the place of the
//               TPU's scalar prefetch; a slot with valid 0 reads no key.
//
// Digits use the key dtype's own shift (logical for unsigned keys, the
// `logical` flag, a template parameter; arithmetic for signed ones), as the
// reference does.  The main path's carrier holds unsigned bits and shifts
// logically.
//
// Bound: bytes.  One read of every key counted (for assigned: of every
// valid slot's tile), r counters per CTA written; no arithmetic to speak
// of.  Supports widths 1..8 (r <= 256).
#include "common.cuh"

constexpr int kHistThreads = 256;

// Adds the digits of keys[begin, end) to the CTA's zeroed (warps, r)
// sub-histograms; warp w takes the 32-key steps w, w + warps, ...
template <typename K, bool LOGICAL>
__device__ void count_digits(const K* __restrict__ keys, long long begin,
                             long long end, int shift, int width, int* sub) {
  const int lane = threadIdx.x & 31;
  int* mine = sub + (threadIdx.x >> 5) * (1 << width);
  for (long long base = begin + (threadIdx.x & ~31); base < end;
       base += blockDim.x) {
    const long long i = base + lane;
    const bool valid = i < end;
    const unsigned d =
        valid ? digit_at(keys[i], shift, width, LOGICAL) : 0u;
    warp_count_step(mine, d, valid, lane);
  }
}

__device__ __forceinline__ void zero_sub(int* sub, int r) {
  for (int i = threadIdx.x; i < (blockDim.x >> 5) * r; i += blockDim.x)
    sub[i] = 0;
}

__device__ __forceinline__ int sum_sub(const int* sub, int r, int d) {
  int s = 0;
  for (int w = 0; w < (blockDim.x >> 5); ++w) s += sub[w * r + d];
  return s;
}

template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const K* __restrict__ keys, long long n, long long chunk,
            int shift, int width, int* __restrict__ out, int accumulate) {
  extern __shared__ int sub[];  // (warps, r) per-warp sub-histograms
  const int r = 1 << width;
  zero_sub(sub, r);
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  count_digits<K, LOGICAL>(keys, begin, min(begin + chunk, n), shift, width,
                           sub);
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    const int s = sum_sub(sub, r, d);
    if (accumulate) {
      if (s) atomicAdd(out + d, s);
    } else {
      out[static_cast<long long>(blockIdx.x) * r + d] = s;
    }
  }
}

template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
assigned_kernel(const K* __restrict__ keys, int tiles, int kpb,
                const int* __restrict__ tile_idx,
                const int* __restrict__ valid, int shift, int width,
                int* __restrict__ out) {
  extern __shared__ int sub[];
  const int r = 1 << width;
  int* row = out + static_cast<long long>(blockIdx.x) * r;
  const int v = valid[blockIdx.x];
  if (v == 0) {
    for (int d = threadIdx.x; d < r; d += blockDim.x) row[d] = 0;
    return;
  }
  // the reference's block index: [-T, -1] counts from the end, then clamp
  int t = tile_idx[blockIdx.x];
  if (t < 0) t += tiles;
  t = min(max(t, 0), tiles - 1);
  zero_sub(sub, r);
  __syncthreads();
  const long long begin = static_cast<long long>(t) * kpb;
  count_digits<K, LOGICAL>(keys, begin, begin + kpb, shift, width, sub);
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x)  // int32 wrap, as XLA
    row[d] = static_cast<int>(static_cast<unsigned>(sum_sub(sub, r, d)) *
                              static_cast<unsigned>(v));
}

REPRO_ERROR_STRING

// keys: n keys of key_bytes each.  CTA b counts keys [b*chunk, (b+1)*chunk).
// accumulate=0: out is (grid, 2^width) rows; accumulate=1: out is a zeroed
// (2^width,) total that every CTA adds into.
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int key_bytes, long long chunk, int grid,
                                      int shift, int width, int logical,
                                      void* out, int accumulate,
                                      void* stream) {
  if (width < 1 || width > 8 || grid < 1) return cudaErrorInvalidValue;
  const size_t shmem = sizeof(int) * (kHistThreads / 32) * (1 << width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? hist_kernel<K, true> : hist_kernel<K, false>;
    kernel<<<grid, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), n, chunk, shift, width,
        static_cast<int*>(out), accumulate);
  })
  return static_cast<int>(cudaGetLastError());
}

// keys: (tiles, kpb); tile_idx, valid: (slots,) int32; out: (slots,
// 2^width) int32, every row written.
extern "C" int assigned_histogram_launch(const void* keys, int key_bytes,
                                         int tiles, int kpb,
                                         const int* tile_idx,
                                         const int* valid, int slots,
                                         int shift, int width, int logical,
                                         void* out, void* stream) {
  if (width < 1 || width > 8 || tiles < 1 || kpb < 1 || slots < 1)
    return cudaErrorInvalidValue;
  const size_t shmem = sizeof(int) * (kHistThreads / 32) * (1 << width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? assigned_kernel<K, true>
                          : assigned_kernel<K, false>;
    kernel<<<slots, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), tiles, kpb, tile_idx, valid, shift,
        width, static_cast<int*>(out));
  })
  return static_cast<int>(cudaGetLastError());
}
