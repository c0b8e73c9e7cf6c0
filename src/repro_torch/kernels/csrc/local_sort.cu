// Stable local sort of small buckets: the port of
// repro/kernels/bitonic.py::_bitonic_stable_kernel.
//
// The TPU kernel sorted a padded (S, L) table of (key, idx) rows held in
// VMEM with a bitonic network.  Two entries here:
//
//   * segments (the main path; redesigned for the H100).  One launch per
//     size class sorts the done buckets (start[j], size[j]) of the key
//     buffer in place and moves up to kMaxLeaves value leaves in place with
//     them; in perm mode it also writes each sorted slot's source position
//     (the library's segmented_local_sort(..., perm=)).  No padded table
//     exists in device memory.
//   * rows: the (S, L) table contract of bitonic_sort_rows_stable, not on
//     the main path.  Its idx is any distinct int32, not the position, so a
//     key-only radix sort does not give its (key, idx) order: it keeps the
//     bitonic network over (key, idx) pairs in shared memory, one CTA a row.
//
// segments.  A done bucket's keys agree on every bit above the digits the
// counting passes have split, and often on more.  So the CTA ORs
// key ^ key_0 over the bucket and sorts only the bits [ctz, top] of that
// difference, by a stable LSD radix sort of ceil(w / 8) digit passes in
// shared memory (the last digit may be narrower).  Outside the window all
// keys are equal and every pass is stable, so the result is exactly the
// reference's (key, position) order, with no tie-break and no pads.  A
// bucket whose keys are all equal is already in that order: nothing is
// written (perm mode: identity positions).  Uniform uint32 keys at 2^28
// leave about 16 live bits: two digit passes in place of the network's
// 78-91 barrier stages.  Per bucket:
//   1. the keys come into shared memory with 16-byte loads (scalar head and
//      tail: bucket starts are arbitrary), then into registers warp-striped:
//      warp w owns a contiguous slice of the bucket and lane l its
//      positions l, l + 32, ..., so a warp's steps run in index order;
//   2. per digit pass: in-warp ranks through the per-warp digit bitmasks
//      (warp_mask_rank, shared with the fused pass), one block-wide
//      exclusive scan over (digit, warp), the keys and their 16-bit source
//      indices scattered into shared memory and read back warp-striped:
//      four barriers and a scan per pass.  Lanes past the bucket's size take
//      no part (no all-ones pads: real all-ones keys keep their place);
//   3. the keys go back in place; then each leaf's slice is staged in shared
//      memory (coalesced 16-byte loads) and written back in place,
//      leaf[start + j] = staged[src[j]], coalesced.
// Persistent CTAs: as many as fit the card at once; CTA b takes rows b,
// b + G, ... (G CTAs).  A round reads one size per thread and skips when
// none is live, so a class with no live row costs one read of its size
// table.  As a bucket starts, L2 is asked for its leaves (read last) and
// for the next bucket's keys.  Threads and keys per thread are chosen per
// class (launch_segments); one bucket per CTA at a time (packing several
// small buckets into one CTA is left for later).
//
// Bound: bytes.  Each live key read and written once, each leaf element
// read and written once (a 4-byte position written per key in perm mode),
// the size table and the live rows' starts.  Shared memory (SegLayout): a
// staging buffer of cap * max(key, widest leaf) bytes, 2 * cap bytes of
// source indices and a (warps, 256) table each of uint16 counts and uint32
// digit bitmasks; at cap 16384 with 8-byte keys and leaves 208 KB.  A shape
// over the card's opt-in limit (227 KB), or a class over 16384, is refused.
#include <atomic>

#include "common.cuh"

constexpr int kMaxLeaves = 8;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;

// ---- segments -------------------------------------------------------------

struct SegLeaves {
  void* ptr[kMaxLeaves];
  int bytes[kMaxLeaves];
  int count;
};

struct SegArgs {
  const int* starts;
  const int* sizes;
  int* perm;          // null: no positions written
  SegLeaves leaves;
  int rows;
  int leaf_bytes;     // the widest leaf (0 without leaves)
  int fixed_bits;     // > 0: sort bits [0, fixed_bits) of every bucket
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory of a CTA of `warps` warps that
// holds `cap` keys.
struct SegLayout {
  size_t idx, cnt, masks, total;
  __host__ __device__ SegLayout(int cap, int warps, int key_bytes,
                                int leaf_bytes) {
    const size_t c = static_cast<size_t>(cap);
    idx = align16(c * (key_bytes > leaf_bytes ? key_bytes : leaf_bytes));
    cnt = align16(idx + 2 * c);
    masks = cnt + 2 * static_cast<size_t>(warps) * kRadix;
    total = masks + 4 * static_cast<size_t>(warps) * kRadix;
  }
};

// Block-wide exclusive sum of one int per thread (`warp_tot`: 32 ints).
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t =
        lane < static_cast<int>(blockDim.x >> 5) ? warp_tot[lane] : 0;
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += x;
    }
    warp_tot[lane] = s - t;
  }
  __syncthreads();
  return incl - v + warp_tot[warp];
}

// The digit (key >> shift) & mask, the key widened first (shift < 64).
template <typename K>
__device__ __forceinline__ unsigned key_digit(K key, int shift,
                                              unsigned mask) {
  return static_cast<unsigned>(static_cast<unsigned long long>(key) >>
                               shift) & mask;
}

// One leaf of a sorted bucket, in place: its slice into the staging buffer,
// then slot p (warp-striped, as the keys) from staged source index src.
template <typename T, int IPT>
__device__ __forceinline__ void move_leaf(void* leaf, long long start,
                                          int size, void* stage,
                                          const unsigned (&src)[IPT],
                                          int wbeg, int wend, int lane) {
  T* base = static_cast<T*>(leaf) + start;
  T* st = static_cast<T*>(stage);
  __syncthreads();  // the staging buffer's last readers are done
  load_row<T>(base, size, st);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int p = wbeg + i * 32 + lane;
    if (p < wend) base[p] = st[src[i] & 0xffffu];
  }
}

// Sort one bucket of at most THREADS * IPT keys (see the note above).
// Every path ends with the block synced, so the next bucket may reuse the
// shared memory.
template <typename K, int THREADS, int IPT>
__device__ __forceinline__ void sort_bucket(
    K* __restrict__ buf, const SegArgs& a, int row, int next,
    unsigned char* smem, const SegLayout& lay, int* s_warp,
    unsigned* s_diff) {
  constexpr int kWarps = THREADS / 32;
  K* skeys = reinterpret_cast<K*>(smem);
  auto* sidx = reinterpret_cast<unsigned short*>(smem + lay.idx);
  auto* cnt = reinterpret_cast<unsigned short*>(smem + lay.cnt);
  auto* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long start = a.starts[row];
  // a size above the class is the caller's error: cut to the CTA's keys
  const int size = min(a.sizes[row], THREADS * IPT);
  if (threadIdx.x == 0) {
    s_diff[0] = s_diff[1] = 0;
    // L2 fetches this bucket's leaves (read last) and the next bucket's
    // keys while this one sorts
    for (int v = 0; v < a.leaves.count; ++v)
      prefetch_l2(a.leaves.ptr[v], start * a.leaves.bytes[v],
                  (start + size) * a.leaves.bytes[v]);
    if (next >= 0)
      prefetch_l2(buf, a.starts[next] * static_cast<long long>(sizeof(K)),
                  (a.starts[next] + static_cast<long long>(a.sizes[next])) *
                      sizeof(K));
  }
  load_row<K>(buf + start, size, skeys);
  __syncthreads();

  // 1. warp-striped keys; the bucket's differing bits
  const int per = warp_slice_per(size, kWarps);
  const int wbeg = warp * per;
  const int wend = min(wbeg + per, size);
  const K key0 = skeys[0];
  K key[IPT];
  unsigned src[IPT];  // low 16 bits: source index; high: in-warp rank
  unsigned long long diff = 0;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int p = wbeg + i * 32 + lane;
    key[i] = p < wend ? skeys[p] : key0;
    src[i] = static_cast<unsigned>(p);
    diff |= static_cast<unsigned long long>(key[i] ^ key0);
  }
  const unsigned dlo =
      __reduce_or_sync(kFullMask, static_cast<unsigned>(diff));
  const unsigned dhi =
      __reduce_or_sync(kFullMask, static_cast<unsigned>(diff >> 32));
  if (lane == 0 && (dlo | dhi)) {
    atomicOr(s_diff, dlo);
    atomicOr(s_diff + 1, dhi);
  }
  __syncthreads();
  diff = s_diff[0] | static_cast<unsigned long long>(s_diff[1]) << 32;
  int lo = 0, hi = a.fixed_bits - 1;
  if (a.fixed_bits <= 0) {
    if (diff == 0) {  // all equal: the input order is the stable order
      if (a.perm)
        for (int j = threadIdx.x; j < size; j += THREADS)
          a.perm[start + j] = static_cast<int>(start + j);
      __syncthreads();
      return;
    }
    lo = __ffsll(static_cast<long long>(diff)) - 1;
    hi = 63 - __clzll(static_cast<long long>(diff));
  }

  // 2. stable LSD digit passes over bits [lo, hi]
  unsigned short* mine = cnt + warp * kRadix;
  unsigned* wmask = masks + warp * kRadix;
  for (int shift = lo; shift <= hi; shift += kDigitBits) {
    const int width = min(kDigitBits, hi + 1 - shift);
    const unsigned mask = (1u << width) - 1u;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (wbeg + i * 32 < wend) {  // warp-uniform
        const bool valid = wbeg + i * 32 + lane < wend;
        const int rank = warp_mask_rank(
            mine, wmask, key_digit(key[i], shift, mask), valid, lane);
        src[i] = (src[i] & 0xffffu) | static_cast<unsigned>(rank) << 16;
      }
    }
    __syncthreads();
    {  // exclusive offsets over (digit, warp): entry e = d * kWarps + w
      const int entries = (1 << width) * kWarps;
      const int chunk = (entries + THREADS - 1) / THREADS;
      const int e0 = min(entries, static_cast<int>(threadIdx.x) * chunk);
      const int e1 = min(entries, e0 + chunk);
      int sum = 0;
      for (int e = e0; e < e1; ++e)
        sum += cnt[(e % kWarps) * kRadix + e / kWarps];
      int run = block_exclusive_sum(sum, s_warp);
      for (int e = e0; e < e1; ++e) {
        unsigned short* c = cnt + (e % kWarps) * kRadix + e / kWarps;
        const int v = *c;
        *c = static_cast<unsigned short>(run);
        run += v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (wbeg + i * 32 + lane < wend) {
        const int dst = mine[key_digit(key[i], shift, mask)] + (src[i] >> 16);
        skeys[dst] = key[i];
        sidx[dst] = static_cast<unsigned short>(src[i]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int p = wbeg + i * 32 + lane;
      if (p < wend) {
        key[i] = skeys[p];
        src[i] = sidx[p];
      }
    }
    for (int e = threadIdx.x; e < kWarps * kRadix; e += THREADS) cnt[e] = 0;
    __syncthreads();
  }

  // 3. keys (and positions) back in place, then each leaf
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int p = wbeg + i * 32 + lane;
    if (p < wend) {
      buf[start + p] = key[i];
      if (a.perm)
        a.perm[start + p] = static_cast<int>(start + (src[i] & 0xffffu));
    }
  }
  for (int v = 0; v < a.leaves.count; ++v) {
    void* leaf = a.leaves.ptr[v];
    switch (a.leaves.bytes[v]) {
      case 1: move_leaf<uint8_t, IPT>(leaf, start, size, smem, src, wbeg,
                                      wend, lane); break;
      case 2: move_leaf<uint16_t, IPT>(leaf, start, size, smem, src, wbeg,
                                       wend, lane); break;
      case 4: move_leaf<uint32_t, IPT>(leaf, start, size, smem, src, wbeg,
                                       wend, lane); break;
      default: move_leaf<unsigned long long, IPT>(leaf, start, size, smem,
                                                  src, wbeg, wend, lane);
    }
  }
  __syncthreads();
}

// CTAs of THREADS threads per SM that the register budget must allow:
// at 512 and 256 threads, 2 and 4 (64 registers a thread) for keys of up
// to 4 bytes, measured faster than fewer CTAs with more registers
// (PERF.md); 8-byte keys, 16 of which take 32 registers, are not bounded.
template <typename K, int THREADS>
constexpr int min_ctas() {
  return sizeof(K) == 8 ? 1 : THREADS == 512 ? 2 : THREADS == 256 ? 4 : 1;
}

// Persistent CTAs over one class's rows: CTA b takes rows b, b + G, ...,
// THREADS rows a round (one size read per thread), the live ones in order.
template <typename K, int THREADS, int IPT>
__global__ void __launch_bounds__(THREADS, (min_ctas<K, THREADS>()))
segments_kernel(K* __restrict__ buf, const __grid_constant__ SegArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_row[THREADS];
  __shared__ int s_warp[32];
  __shared__ unsigned s_diff[2];
  constexpr int kWarps = THREADS / 32;
  const SegLayout lay(THREADS * IPT, kWarps, sizeof(K), a.leaf_bytes);
  auto* cnt = reinterpret_cast<unsigned short*>(smem + lay.cnt);
  auto* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  for (int e = threadIdx.x; e < kWarps * kRadix; e += THREADS) {
    cnt[e] = 0;
    masks[e] = 0;
  }
  const long long round = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = 0; base < a.rows; base += round) {
    const long long row =
        base + static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x;
    const bool live = row < a.rows && a.sizes[row] > 0;
    s_row[threadIdx.x] = live ? static_cast<int>(row) : -1;
    if (!__syncthreads_or(live)) continue;
    for (int j = 0; j < THREADS; ++j) {
      const int r = s_row[j];
      if (r >= 0)
        sort_bucket<K, THREADS, IPT>(buf, a, r,
                                     j + 1 < THREADS ? s_row[j + 1] : -1,
                                     smem, lay, s_warp, s_diff);
    }
    __syncthreads();  // s_row is written again next round
  }
}

// ---- rows (the bitonic network) -------------------------------------------

template <typename K>
__device__ __forceinline__ bool pair_less(K ka, int ia, K kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

template <typename K>
__device__ void bitonic_pairs(K* keys, int* idx, int len) {
  const int half = len >> 1;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = threadIdx.x; c < half; c += blockDim.x) {
        const int i = 2 * stride * (c / stride) + (c % stride);
        const int p = i + stride;
        const bool ascending = (i & size) == 0;
        const K ki = keys[i], kp = keys[p];
        const int ii = idx[i], ip = idx[p];
        if (pair_less(kp, ip, ki, ii) == ascending) {
          keys[i] = kp; keys[p] = ki;
          idx[i] = ip; idx[p] = ii;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline size_t key_smem_bytes(int len, size_t key_bytes) {
  return (static_cast<size_t>(len) * key_bytes + 7) / 8 * 8;
}

template <typename K>
__global__ void rows_kernel(const K* __restrict__ in_keys,
                            const int* __restrict__ in_idx,
                            K* __restrict__ out_keys, int* __restrict__ out_idx,
                            int len) {
  extern __shared__ unsigned long long smem_raw[];
  K* keys = reinterpret_cast<K*>(smem_raw);
  int* idx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem_raw) +
                                    key_smem_bytes(len, sizeof(K)));
  const long long row = static_cast<long long>(blockIdx.x) * len;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    keys[j] = in_keys[row + j];
    idx[j] = in_idx[row + j];
  }
  __syncthreads();
  bitonic_pairs(keys, idx, len);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    out_keys[row + j] = keys[j];
    out_idx[row + j] = idx[j];
  }
}

REPRO_ERROR_STRING

static int threads_for(int len) { return len >= 1024 ? 512 : (len / 2 > 32 ? len / 2 : 32); }

// (S, L) rows of keys and int32 idx -> rows sorted by (key, idx).
extern "C" int sort_rows_launch(const void* keys, const void* idx,
                                void* out_keys, void* out_idx, int key_bytes,
                                int rows, int len, void* stream) {
  if (len < 2 || (len & (len - 1)) || rows < 1) return cudaErrorInvalidValue;
  const size_t shmem = key_smem_bytes(len, key_bytes) + sizeof(int) * len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    const int e = static_cast<int>(cudaFuncSetAttribute(
        rows_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem)));
    if (e) return e;
    rows_kernel<K><<<rows, threads_for(len), shmem, s>>>(
        static_cast<const K*>(keys), static_cast<const int*>(idx),
        static_cast<K*>(out_keys), static_cast<int*>(out_idx), len);
  })
  return static_cast<int>(cudaGetLastError());
}

// ---- segments: launch -----------------------------------------------------

// One class of THREADS x IPT keys per CTA.  `ctas` > 0 fixes the grid;
// else as many CTAs as fit the card at once, at most one per row.  The
// CUDA queries behind that grid cost more than an empty class's launch, so
// each kernel makes them once per device and shared-memory size (`memo`:
// device + 1, shared bytes and grid in one word).
template <typename K, int THREADS, int IPT>
static cudaError_t launch_class(K* buf, const SegArgs& a, int ctas,
                                cudaStream_t s) {
  static std::atomic<unsigned long long> memo{0};
  const size_t shmem =
      SegLayout(THREADS * IPT, THREADS / 32, sizeof(K), a.leaf_bytes).total;
  auto kernel = segments_kernel<K, THREADS, IPT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long tag = static_cast<unsigned long long>(dev + 1)
                                     << 56 |
                                 static_cast<unsigned long long>(shmem) << 32;
  unsigned long long m = memo.load(std::memory_order_relaxed);
  if ((m & ~0xffffffffull) != tag) {
    int optin = 0, per_sm = 0, sms = 0;
    cudaFuncAttributes attr;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (shmem + attr.sharedSizeBytes > static_cast<size_t>(optin))
      return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, shmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    m = tag | static_cast<unsigned>(per_sm * sms);
    memo.store(m, std::memory_order_relaxed);
  }
  if (ctas <= 0) ctas = min(a.rows, static_cast<int>(m & 0xffffffffu));
  kernel<<<ctas, THREADS, shmem, s>>>(buf, a);
  return cudaGetLastError();
}

// Threads x keys per thread for a class of width len.
template <typename K>
static cudaError_t launch_segments(void* buf, const SegArgs& a, int len,
                                   int ctas, cudaStream_t s) {
  K* b = static_cast<K*>(buf);
  if (len <= 128) return launch_class<K, 32, 4>(b, a, ctas, s);
  if (len <= 512) return launch_class<K, 64, 8>(b, a, ctas, s);
  if (len <= 1024) return launch_class<K, 128, 8>(b, a, ctas, s);
  if (len <= 2048) return launch_class<K, 256, 8>(b, a, ctas, s);
  if (len <= 4096) return launch_class<K, 256, 16>(b, a, ctas, s);
  if (len <= 8192) return launch_class<K, 512, 16>(b, a, ctas, s);
  if (len <= 16384) return launch_class<K, 1024, 16>(b, a, ctas, s);
  return cudaErrorInvalidValue;
}

// One size class: `rows` buckets (starts, sizes), each at most len keys,
// sorted in place in the key buffer; the num_leaves leaves (1, 2, 4 or
// 8-byte elements) moved in place with them; perm (may be null) gets each
// sorted slot's source position.  fixed_bits > 0 sorts bits
// [0, fixed_bits) of every bucket in place of its live window (a timing
// variant: the order is the sort's only where the keys agree above it);
// ctas > 0 fixes the grid.
extern "C" int sort_segments_launch(void* buf, void* perm, const int* starts,
                                    const int* sizes, int key_bytes, int rows,
                                    int len, void* const* leaf_ptrs,
                                    const int* leaf_bytes, int num_leaves,
                                    int fixed_bits, int ctas, void* stream) {
  if (len < 1 || rows < 1 || num_leaves < 0 || num_leaves > kMaxLeaves ||
      fixed_bits < 0 || fixed_bits > 8 * key_bytes)
    return cudaErrorInvalidValue;
  SegArgs a{};
  a.starts = starts;
  a.sizes = sizes;
  a.perm = static_cast<int*>(perm);
  a.rows = rows;
  a.fixed_bits = fixed_bits;
  a.leaves.count = num_leaves;
  for (int v = 0; v < num_leaves; ++v) {
    const int b = leaf_bytes[v];
    if (b != 1 && b != 2 && b != 4 && b != 8) return cudaErrorInvalidValue;
    a.leaves.ptr[v] = leaf_ptrs[v];
    a.leaves.bytes[v] = b;
    a.leaf_bytes = max(a.leaf_bytes, b);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    return static_cast<int>(launch_segments<K>(buf, a, len, ctas, s));
  })
  return static_cast<int>(cudaErrorInvalidValue);
}
