// Digit histograms: the port of repro/kernels/histogram.py::_hist_kernel
// and of repro/kernels/assigned.py::_assigned_hist_kernel.
//
// Replaces: the TPU kernels formed a one-hot (KPB, r) matrix per tile and
// contracted it with ones on the MXU.
//
// hist_kernel (rows and total; redesigned for the H100).  What bounds it
// on this card is the key read: one pass over n keys at 3.35 TB/s, with
// next to no arithmetic.  Two things held the first version back: scalar
// 4-byte loads (too few bytes in flight) and __match_any_sync per 32-key
// step, whose cost grows with the distinct digits of a warp (uniform keys
// took 3.5x all-equal ones).  So:
//   * each thread reads 16 bytes at a time (4 uint32, 2 uint64, 8 uint16 or
//     16 uint8 keys), two vectors per loop turn; a scalar head and tail
//     cover a range whose start or length is not a multiple of 16 bytes
//     (the head is the wrapper's `aligned_split`, moved per tile in rows
//     mode);
//   * counting is match-free: plain shared atomicAdd into one
//     sub-histogram per warp, so only lanes of one warp can collide;
//   * for skew, the paper's Fig. 2 thread reduction in registers: a thread
//     carries (digit, run length) across every key it reads and adds a run
//     once when the digit changes, so all-equal keys cost one shared atomic
//     per thread, not one per key;
//   * the total (the main path's prologue) runs a grid sized from the SM
//     count (kHistCtasPerSm CTAs each, grid-stride), and each CTA adds each
//     bin to the (r,) total with one global atomic; rows mode (one CTA per
//     tile) stores its row.
//
// assigned_kernel (unchanged): CTA g reads its own descriptor (tile_idx[g],
// valid[g]) from global memory, counts that tile into per-warp
// sub-histograms merging a warp's equal digits with __match_any_sync
// (count_digits), and stores the row times valid[g].  This takes the place
// of the TPU's scalar prefetch; a slot with valid 0 reads no key.
//
// Digits use the key dtype's own shift (logical for unsigned keys, the
// `logical` flag, a template parameter; arithmetic for signed ones), as the
// reference does.  The main path's carrier holds unsigned bits and shifts
// logically.  hist_kernel takes widths 1..9 (r <= 512: 8 warps' (r,) int
// sub-histograms are 16 KB), assigned_kernel widths 1..8.
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

// A thread's run of equal digits (the Fig. 2 reduction in registers).
struct DigitRun {
  unsigned digit = 0;
  int count = 0;
  __device__ __forceinline__ void add(unsigned d, int* mine) {
    if (d == digit) {
      ++count;
      return;
    }
    if (count) atomicAdd(mine + digit, count);
    digit = d;
    count = 1;
  }
  __device__ __forceinline__ void flush(int* mine) {
    if (count) atomicAdd(mine + digit, count);
    count = 0;
  }
};

// Counts keys[begin, end) into `mine`, thread `t` of `threads`: the
// `head` keys before the first 16-byte boundary one key per thread, then
// 16-byte vectors, then the tail.
template <typename K, bool LOGICAL>
__device__ void count_range(const K* __restrict__ keys, long long begin,
                            long long end, long long head, long long t,
                            long long threads, int shift, int width,
                            int* mine) {
  constexpr int V = 16 / sizeof(K);
  DigitRun run;
  head = min(head, end - begin);
  if (t < head) run.add(digit_at(keys[begin + t], shift, width, LOGICAL),
                        mine);
  const long long vbegin = begin + head;
  const long long nvec = (end - vbegin) / V;
  const uint4* vec = reinterpret_cast<const uint4*>(keys + vbegin);
  long long v = t;
  for (; v + threads < nvec; v += 2 * threads) {
    KeyVec<K> a, b;
    a.v = __ldcs(vec + v);
    b.v = __ldcs(vec + v + threads);
#pragma unroll
    for (int e = 0; e < V; ++e)
      run.add(digit_at(a.k[e], shift, width, LOGICAL), mine);
#pragma unroll
    for (int e = 0; e < V; ++e)
      run.add(digit_at(b.k[e], shift, width, LOGICAL), mine);
  }
  if (v < nvec) {
    KeyVec<K> a;
    a.v = __ldcs(vec + v);
#pragma unroll
    for (int e = 0; e < V; ++e)
      run.add(digit_at(a.k[e], shift, width, LOGICAL), mine);
  }
  const long long tail = vbegin + nvec * V;
  if (t < end - tail)
    run.add(digit_at(keys[tail + t], shift, width, LOGICAL), mine);
  run.flush(mine);
}

// rows (accumulate 0): CTA b counts keys [b*chunk, (b+1)*chunk) and stores
// its (r,) row; total (accumulate 1): the grid strides over [0, n) and
// every CTA adds into the zeroed (r,) total.  head0 = the keys before the
// first 16-byte boundary of `keys`.
template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const K* __restrict__ keys, long long n, long long chunk,
            int head0, int shift, int width, int* __restrict__ out,
            int accumulate) {
  constexpr int V = 16 / sizeof(K);
  extern __shared__ int sub[];  // (warps, r) per-warp sub-histograms
  const int r = 1 << width;
  zero_sub(sub, r);
  __syncthreads();
  int* mine = sub + (threadIdx.x >> 5) * r;
  if (accumulate) {
    count_range<K, LOGICAL>(
        keys, 0, n, head0,
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
        static_cast<long long>(gridDim.x) * blockDim.x, shift, width, mine);
  } else {
    const long long begin = static_cast<long long>(blockIdx.x) * chunk;
    const long long head = ((head0 - begin) % V + V) % V;
    count_range<K, LOGICAL>(keys, begin, min(begin + chunk, n), head,
                            threadIdx.x, blockDim.x, shift, width, mine);
  }
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

// keys: n keys of key_bytes each, head0 of them before the first 16-byte
// boundary.  accumulate=0: CTA b counts keys [b*chunk, (b+1)*chunk) into
// row b of out, (grid, 2^width); accumulate=1: `grid` CTAs stride over the
// keys and add into out, a zeroed (2^width,) total.
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int key_bytes, long long chunk, int grid,
                                      int head0, int shift, int width,
                                      int logical, void* out, int accumulate,
                                      void* stream) {
  if (width < 1 || width > 9 || grid < 1 || head0 < 0 ||
      head0 * key_bytes >= 16)
    return cudaErrorInvalidValue;
  const size_t shmem = sizeof(int) * (kHistThreads / 32) * (1 << width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? hist_kernel<K, true> : hist_kernel<K, false>;
    kernel<<<grid, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), n, chunk, head0, shift, width,
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
