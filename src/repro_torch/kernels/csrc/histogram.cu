// Digit histogram: the port of repro/kernels/histogram.py::_hist_kernel.
//
// Replaces: the TPU kernel formed a one-hot (KPB, r) matrix per tile and
// contracted it with ones on the MXU.  Here each CTA counts the digits of
// its key range into per-warp sub-histograms in shared memory, merging the
// lanes of a warp that hold the same digit first (__match_any_sync, the
// paper's Fig. 2 thread reduction), so an all-equal tile costs one shared
// atomic per warp step instead of 32 on one address.  The per-warp rows are
// summed per CTA and either stored as the CTA's row (the (T, r) contract,
// one CTA per tile) or added to one (r,) total with one global atomic per
// bin (the main path's prologue, a few thousand CTAs over the whole array).
//
// Bound: bytes.  One read of every key, r counters per CTA written; no
// arithmetic to speak of.  Supports widths 1..8 (r <= 256).
#include "common.cuh"

constexpr int kHistThreads = 256;

template <typename K>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const K* __restrict__ keys, long long n, long long chunk,
            int shift, int width, int* __restrict__ out, int accumulate) {
  extern __shared__ int sub[];  // (warps, r) per-warp sub-histograms
  const int r = 1 << width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < warps * r; i += blockDim.x) sub[i] = 0;
  __syncthreads();

  int* mine = sub + warp * r;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(begin + chunk, n);
  for (long long base = begin + warp * 32; base < end; base += blockDim.x) {
    const long long i = base + lane;
    const bool valid = i < end;
    const unsigned want = __ballot_sync(kFullMask, valid);
    if (valid) {
      const unsigned d = digit_of(keys[i], shift, width);
      const unsigned peers = __match_any_sync(want, d);
      if (lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += sub[w * r + d];
    if (accumulate) {
      if (s) atomicAdd(out + d, s);
    } else {
      out[static_cast<long long>(blockIdx.x) * r + d] = s;
    }
  }
}

REPRO_ERROR_STRING

// keys: n keys of key_bytes each.  CTA b counts keys [b*chunk, (b+1)*chunk).
// accumulate=0: out is (grid, 2^width) rows; accumulate=1: out is a zeroed
// (2^width,) total that every CTA adds into.
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int key_bytes, long long chunk, int grid,
                                      int shift, int width, void* out,
                                      int accumulate, void* stream) {
  if (width < 1 || width > 8 || grid < 1) return cudaErrorInvalidValue;
  const size_t shmem = sizeof(int) * (kHistThreads / 32) * (1 << width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K,
    hist_kernel<K><<<grid, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), n, chunk, shift, width,
        static_cast<int*>(out), accumulate))
  return static_cast<int>(cudaGetLastError());
}
