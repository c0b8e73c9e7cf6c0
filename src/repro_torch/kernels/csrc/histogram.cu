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
// assigned_kernel (redesigned for the H100).  Slot g histograms tile
// tile_idx[g] and stores the row times valid[g]; a slot with valid 0 reads
// no key.  Its bound is the same key read.  The first version counted
// widths 1..8 with count_digits: one scalar 4-byte load per lane and 32-key
// step, each step a __ballot_sync, a __match_any_sync and a __syncwarp, and
// reached 13 % of the bound at the library phase's 43 692 slots of 6 912
// keys.  Now every width counts as hist_kernel does, with count_range
// (16-byte loads, register runs of equal digits, plain shared atomics),
// into one shared (r,) table per CTA through 14 bits and past them with
// global atomics into the slot's zeroed row, adding valid[g] per key (the
// same int32 wrap as the product).  One CTA per slot: a warp per slot,
// with or without a grid sized from the SM count taking slots in turn,
// and one table per warp (the prologue's layout) measured no faster
// (PERF.md), so the per-slot zeroing and barriers stay, hidden by
// the other resident CTAs.
//
// Digit widths 10..16 (r = 1024 .. 65536), both kernels: the per-warp
// sub-histograms would not fit past r = 512, so the CTA counts into one
// shared (r,) table while it fits (r <= 16384: 64 KB), and past that into
// device memory with global atomics (the output row), the register runs of
// equal digits merging a skewed input's adds as before.  The table count
// is a launch argument: 8 (one per warp), 1 or 0.  The total past 14 bits
// runs split_total_kernel: the bins split into parts of 2^14, one shared
// table each (one global atomic per key lost to torch.bincount at 16 bits).
//
// Digits use the key dtype's own shift (logical for unsigned keys, the
// `logical` flag, a template parameter; arithmetic for signed ones), as the
// reference does.  The main path's carrier holds unsigned bits and shifts
// logically.  Both kernels take widths 1..16.
#include "common.cuh"

#include <algorithm>

constexpr int kHistThreads = 256;

// Shared (r,) tables per CTA by digit width: one per warp up to r = 512,
// one for the CTA up to r = 16384 (64 KB), none past it (global atomics).
constexpr int kWarpTablesMaxWidth = 9;
constexpr int kCtaTableMaxWidth = 14;
// the bins of one part of split_total_kernel: one CTA table
constexpr unsigned kSplitBins = 1u << kCtaTableMaxWidth;

__host__ __device__ inline int hist_tables(int width) {
  return width <= kWarpTablesMaxWidth ? kHistThreads / 32
         : width <= kCtaTableMaxWidth ? 1 : 0;
}

__device__ __forceinline__ void zero_sub(int* sub, int r, int tables) {
  for (int i = threadIdx.x; i < tables * r; i += blockDim.x) sub[i] = 0;
}

__device__ __forceinline__ int sum_sub(const int* sub, int r, int d,
                                       int tables) {
  int s = 0;
  for (int w = 0; w < tables; ++w) s += sub[w * r + d];
  return s;
}

// A thread's run of equal digits (the Fig. 2 reduction in registers); a
// run adds count * scale (scale 1, or the assigned slot's valid[g]).
struct DigitRun {
  unsigned digit = 0;
  int count = 0;
  __device__ __forceinline__ void add(unsigned d, int* mine, int scale) {
    if (d == digit) {
      ++count;
      return;
    }
    flush(mine, scale);
    digit = d;
    count = 1;
  }
  __device__ __forceinline__ void flush(int* mine, int scale) {
    if (count)
      atomicAdd(mine + digit, static_cast<int>(static_cast<unsigned>(count) *
                                               static_cast<unsigned>(scale)));
    count = 0;
  }
};

// Counts keys[begin, end) into `mine` (shared or global; each key adds
// `scale`), thread `t` of `threads`: the `head` keys before the first
// 16-byte boundary one key per thread, then 16-byte vectors, then the tail.
// SPLIT: only the digits of [part_lo, part_lo + kSplitBins) count, at
// `mine[digit - part_lo]`.
template <typename K, bool LOGICAL, bool SPLIT = false>
__device__ void count_range(const K* __restrict__ keys, long long begin,
                            long long end, long long head, long long t,
                            long long threads, int shift, int width,
                            int* mine, int scale = 1, unsigned part_lo = 0) {
  constexpr int V = 16 / sizeof(K);
  DigitRun run;
  auto add = [&](K key) {
    unsigned d = digit_at(key, shift, width, LOGICAL);
    if constexpr (SPLIT) {
      d -= part_lo;
      if (d >= kSplitBins) return;
    }
    run.add(d, mine, scale);
  };
  head = min(head, end - begin);
  if (t < head) add(keys[begin + t]);
  const long long vbegin = begin + head;
  const long long nvec = (end - vbegin) / V;
  const uint4* vec = reinterpret_cast<const uint4*>(keys + vbegin);
  long long v = t;
  for (; v + threads < nvec; v += 2 * threads) {
    KeyVec<K> a, b;
    a.v = __ldcs(vec + v);
    b.v = __ldcs(vec + v + threads);
#pragma unroll
    for (int e = 0; e < V; ++e) add(a.k[e]);
#pragma unroll
    for (int e = 0; e < V; ++e) add(b.k[e]);
  }
  if (v < nvec) {
    KeyVec<K> a;
    a.v = __ldcs(vec + v);
#pragma unroll
    for (int e = 0; e < V; ++e) add(a.k[e]);
  }
  const long long tail = vbegin + nvec * V;
  if (t < end - tail) add(keys[tail + t]);
  run.flush(mine, scale);
}

// The keys before the first 16-byte boundary from key `begin` on, given
// head0 of them from key 0.
template <typename K>
__device__ __forceinline__ long long head_at(int head0, long long begin) {
  constexpr int V = 16 / sizeof(K);
  return ((head0 - begin) % V + V) % V;
}

// rows (accumulate 0): CTA b counts keys [b*chunk, (b+1)*chunk) and stores
// its (r,) row; total (accumulate 1): the grid strides over [0, n) and
// every CTA adds into the zeroed (r,) total.  head0 = the keys before the
// first 16-byte boundary of `keys`; `tables` = hist_tables(width).
template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const K* __restrict__ keys, long long n, long long chunk,
            int head0, int shift, int width, int* __restrict__ out,
            int accumulate, int tables) {
  extern __shared__ int sub[];  // (tables, r) shared sub-histograms
  const int r = 1 << width;
  int* row = out + (accumulate ? 0 : static_cast<long long>(blockIdx.x) * r);
  zero_sub(sub, r, tables);
  if (!tables && !accumulate)   // this CTA's row takes global atomics
    for (int d = threadIdx.x; d < r; d += blockDim.x) row[d] = 0;
  __syncthreads();
  int* mine = !tables ? row : sub + (tables > 1 ? threadIdx.x >> 5 : 0) * r;
  if (accumulate) {
    count_range<K, LOGICAL>(
        keys, 0, n, head0,
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
        static_cast<long long>(gridDim.x) * blockDim.x, shift, width, mine);
  } else {
    const long long begin = static_cast<long long>(blockIdx.x) * chunk;
    count_range<K, LOGICAL>(keys, begin, min(begin + chunk, n),
                            head_at<K>(head0, begin), threadIdx.x,
                            blockDim.x, shift, width, mine);
  }
  if (!tables) return;
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    const int s = sum_sub(sub, r, d, tables);
    if (accumulate) {
      if (s) atomicAdd(out + d, s);
    } else {
      row[d] = s;
    }
  }
}

// The total past 14 bits: part p = blockIdx.y counts only the digits of
// [p·2^14, (p+1)·2^14) into one shared table of 2^14 entries (64 KB) and
// adds its non-zero bins into the zeroed total with global atomics: one
// per bin of a CTA's part in place of one per run of equal digits.  Every
// part reads all the keys; the parts of one stride run in the same wave,
// so the repeated reads mostly hit L2.
template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
split_total_kernel(const K* __restrict__ keys, long long n, int head0,
                   int shift, int width, int* __restrict__ out) {
  extern __shared__ int sub[];  // (kSplitBins,) this part's table
  const unsigned part_lo = blockIdx.y * kSplitBins;
  zero_sub(sub, kSplitBins, 1);
  __syncthreads();
  count_range<K, LOGICAL, true>(
      keys, 0, n, head0,
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<long long>(gridDim.x) * blockDim.x, shift, width, sub, 1,
      part_lo);
  __syncthreads();
  for (int d = threadIdx.x; d < static_cast<int>(kSplitBins);
       d += blockDim.x)
    if (sub[d]) atomicAdd(out + part_lo + d, sub[d]);
}

// The slot's tile: [-T, -1] counts from the end, then any index is clamped
// to [0, T-1], as the reference's block index is.
__device__ __forceinline__ long long slot_begin(int t, int tiles, int kpb) {
  if (t < 0) t += tiles;
  return static_cast<long long>(min(max(t, 0), tiles - 1)) * kpb;
}

// CTA g counts slot g's tile into one zeroed shared (r,) table through 14
// bits and stores it times valid[g]; past 14 bits it counts straight into
// the slot's zeroed row, adding valid[g] per key.  The two counts are
// separate calls, so each knows its table's address space (through one
// pointer that may be either, the 16-bit count measured 5 % slower on
// an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
template <typename K, bool LOGICAL>
__global__ void __launch_bounds__(kHistThreads)
assigned_kernel(const K* __restrict__ keys, int tiles, int kpb,
                const int* __restrict__ tile_idx,
                const int* __restrict__ valid, int shift, int width,
                int* __restrict__ out, int head0) {
  extern __shared__ int sub[];
  const int r = 1 << width;
  int* row = out + static_cast<long long>(blockIdx.x) * r;
  const int v = valid[blockIdx.x];
  if (v == 0) {
    for (int d = threadIdx.x; d < r; d += blockDim.x) row[d] = 0;
    return;
  }
  const long long begin = slot_begin(tile_idx[blockIdx.x], tiles, kpb);
  const long long head = head_at<K>(head0, begin);
  if (width > kCtaTableMaxWidth) {
    zero_sub(row, r, 1);
    __syncthreads();
    count_range<K, LOGICAL>(keys, begin, begin + kpb, head, threadIdx.x,
                            blockDim.x, shift, width, row, v);
    return;
  }
  zero_sub(sub, r, 1);
  __syncthreads();
  count_range<K, LOGICAL>(keys, begin, begin + kpb, head, threadIdx.x,
                          blockDim.x, shift, width, sub);
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x)  // int32 wrap, as XLA
    row[d] = static_cast<int>(static_cast<unsigned>(sub[d]) *
                              static_cast<unsigned>(v));
}

REPRO_ERROR_STRING

// Dynamic shared memory past 48 KB has to be asked for per kernel.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t shmem) {
  return shmem > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(shmem))
             : cudaSuccess;
}

// split_total_kernel's grid: 2^(width - 14) parts of one wave of CTAs at
// the occupancy of their 64 KB table, at most `grid` CTAs each.
static int split_total(const void* keys, long long n, int key_bytes,
                       int grid, int head0, int shift, int width, int logical,
                       void* out, cudaStream_t s) {
  const int parts = 1 << (width - kCtaTableMaxWidth);
  const size_t shmem = sizeof(int) * kSplitBins;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? split_total_kernel<K, true>
                          : split_total_kernel<K, false>;
    int per_sm = 0;
    e = allow_smem(kernel, shmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kHistThreads, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int gx = std::max(1, std::min(grid, per_sm * sms / parts));
    kernel<<<dim3(gx, parts), kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), n, head0, shift, width,
        static_cast<int*>(out));
  })
  return static_cast<int>(cudaGetLastError());
}

// keys: n keys of key_bytes each, head0 of them before the first 16-byte
// boundary.  accumulate=0: CTA b counts keys [b*chunk, (b+1)*chunk) into
// row b of out, (grid, 2^width); accumulate=1: `grid` CTAs stride over the
// keys and add into out, a zeroed (2^width,) total.
extern "C" int radix_histogram_launch(const void* keys, long long n,
                                      int key_bytes, long long chunk, int grid,
                                      int head0, int shift, int width,
                                      int logical, void* out, int accumulate,
                                      void* stream) {
  if (width < 1 || width > 16 || grid < 1 || head0 < 0 ||
      head0 * key_bytes >= 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (accumulate && width > kCtaTableMaxWidth)
    return split_total(keys, n, key_bytes, grid, head0, shift, width,
                       logical, out, s);
  const int tables = hist_tables(width);
  const size_t shmem = sizeof(int) * tables * (1 << width);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? hist_kernel<K, true> : hist_kernel<K, false>;
    const cudaError_t e = allow_smem(kernel, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), n, chunk, head0, shift, width,
        static_cast<int*>(out), accumulate, tables);
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
  if (width < 1 || width > 16 || tiles < 1 || kpb < 1 || slots < 1 ||
      reinterpret_cast<uintptr_t>(keys) % key_bytes)
    return cudaErrorInvalidValue;
  const size_t shmem =
      width <= kCtaTableMaxWidth ? sizeof(int) * (1 << width) : 0;
  const int head0 = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) & 15) / key_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel = logical ? assigned_kernel<K, true>
                          : assigned_kernel<K, false>;
    const cudaError_t e = allow_smem(kernel, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<slots, kHistThreads, shmem, s>>>(
        static_cast<const K*>(keys), tiles, kpb, tile_idx, valid, shift,
        width, static_cast<int*>(out), head0);
  })
  return static_cast<int>(cudaGetLastError());
}
