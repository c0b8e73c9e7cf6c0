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

// Per-warp digit counts over contiguous warp slices: the block's keys
// [0, count) are cut into one slice per warp (warp_slice_per), each walked
// 32 keys at a time in index order; warps_exclusive turns a zeroed
// (warps, r) table of such counts into exclusive offsets across the warps,
// per digit, and writes the block's histogram.
__device__ __forceinline__ int warp_slice_per(int count, int warps) {
  return ((count + warps - 1) / warps + 31) / 32 * 32;
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

// Asks L2 for the whole 16-byte units of bytes [begin, end) from base (the
// bulk prefetch takes 16-byte aligned addresses: a base off a 16-byte
// boundary is rounded inwards as well).
__device__ __forceinline__ void prefetch_l2(const void* base, long long begin,
                                            long long end) {
  const long long at = static_cast<long long>(
      reinterpret_cast<uintptr_t>(base));
  begin = (at + begin + 15) / 16 * 16;
  end = (at + end) / 16 * 16;
  if (end > begin)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(begin),
                 "r"(static_cast<unsigned>(end - begin))
                 : "memory");
}

// Stores get(0 .. m-1) to dst[0 .. m-1] by the whole block, in slot order:
// a scalar head up to the first 16-byte boundary, whole 16-byte vectors, a
// scalar tail.  STREAM marks the vectors evict-first (__stcs): outputs
// that nothing re-reads soon.
template <typename T, bool STREAM = false, typename Get>
__device__ __forceinline__ void store_run(T* dst, int m, Get get) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(
      m, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                           15) / sizeof(T)));
  const int nvec = (m - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = get(i);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    KeyVec<T> a;
#pragma unroll
    for (int e = 0; e < V; ++e) a.k[e] = get(head + v * V + e);
    if (STREAM)
      __stcs(vdst + v, a.v);
    else
      vdst[v] = a.v;
  }
  for (int i = head + nvec * V + threadIdx.x; i < m; i += blockDim.x)
    dst[i] = get(i);
}

// store_run for two int outputs whose starts share their offset from a
// 16-byte boundary: get(i) gives both i-th elements (.x to a, .y to b), so
// whatever they share is read once.
template <bool STREAM, typename Get>
__device__ __forceinline__ void store_pair(int* a, int* b, int m, Get get) {
  const int head = min(
      m, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(a) & 15)) &
                           15) / sizeof(int)));
  const int nvec = (m - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    const int2 x = get(i);
    a[i] = x.x;
    b[i] = x.y;
  }
  int4* va = reinterpret_cast<int4*>(a + head);
  int4* vb = reinterpret_cast<int4*>(b + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int s = head + 4 * v;
    const int2 g0 = get(s), g1 = get(s + 1), g2 = get(s + 2), g3 = get(s + 3);
    const int4 x = make_int4(g0.x, g1.x, g2.x, g3.x);
    const int4 y = make_int4(g0.y, g1.y, g2.y, g3.y);
    if (STREAM) {
      __stcs(va + v, x);
      __stcs(vb + v, y);
    } else {
      va[v] = x;
      vb[v] = y;
    }
  }
  for (int i = head + nvec * 4 + threadIdx.x; i < m; i += blockDim.x) {
    const int2 x = get(i);
    a[i] = x.x;
    b[i] = x.y;
  }
}

// ---- stable digit-major order of a staged tile, digits of 1..16 bits ----

// Bins of one counting round: 8 bits.
constexpr int kRoundBins = 256;

// Exclusive starts of `nb` bin counts, by one warp (each lane a contiguous
// range of bins).
__device__ __forceinline__ void bins_exclusive(const int* bins, int nb,
                                               int* bexcl, int lane) {
  const int each = (nb + 31) / 32;
  const int b0 = min(lane * each, nb), b1 = min(b0 + each, nb);
  int own = 0;
  for (int b = b0; b < b1; ++b) own += bins[b];
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  int acc = incl - own;
  for (int b = b0; b < b1; ++b) {
    bexcl[b] = acc;
    acc += bins[b];
  }
}

// The stable digit-major order of elements [0, count) of a staged tile,
// digit(i) < 2^width (width 1..16), by the whole block of WARPS warps: one
// stable counting round over the digit's low min(width, 8) bits, then
// (width > 8) a second over its high bits, walking the first round's order
// (least significant first, so equal digits keep their index order).  Each
// round: every warp walks its contiguous slice of the round's input order
// 32 elements a step and ranks them through warp_mask_rank (no
// __match_any_sync); warps_exclusive makes the per-warp counts offsets
// across warps; one warp takes the bins' exclusive starts; a second walk
// places every element at bin start + warp offset + in-warp rank.
//
// Out: order[s], the element at slot s, and sdig[s], its digit.  Scratch:
// tmp (count entries: one-round ranks, or the first round's order), wcnt
// (WARPS x 256 ints), masks (WARPS x 256, zero on entry and on return),
// bins and bexcl (256 ints each).  After a one-round order (width <= 8)
// bins holds the digit histogram and bexcl each digit's first slot.  A
// two-round order keeps its second round's ranks in sdig, so D is 16-bit
// there.  Ends with the block synchronised.
template <int WARPS, typename D, typename DigitFn>
__device__ void stable_digit_order(int count, int width, DigitFn digit,
                                   unsigned short* order, unsigned short* tmp,
                                   D* sdig, int* wcnt, unsigned* masks,
                                   int* bins, int* bexcl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = warp_slice_per(count, WARPS);
  const int wbeg = min(warp * per, count);
  const int wend = min(wbeg + per, count);
  const int rounds = width > 8 ? 2 : 1;
  unsigned* wmask = masks + warp * kRoundBins;
  for (int round = 0; round < rounds; ++round) {
    const int lo = 8 * round;
    const int nb = 1 << min(width - lo, 8);
    // this round's input order, where its in-warp ranks go, its output
    const unsigned short* src = round ? tmp : nullptr;
    unsigned short* ranks = rounds == 1 ? tmp : round ? reinterpret_cast<
        unsigned short*>(sdig) : order;
    unsigned short* dst = rounds == 2 && round == 0 ? tmp : order;
    int* mine = wcnt + warp * nb;
    for (int i = threadIdx.x; i < WARPS * nb; i += blockDim.x) wcnt[i] = 0;
    __syncthreads();
    for (int base = wbeg; base < wend; base += 32) {
      const int j = base + lane;
      const bool valid = j < wend;
      const unsigned b =
          valid ? (digit(src ? src[j] : j) >> lo) & (nb - 1) : 0u;
      const int rank = warp_mask_rank(mine, wmask, b, valid, lane);
      if (valid) ranks[j] = static_cast<unsigned short>(rank);
    }
    __syncthreads();
    warps_exclusive(wcnt, WARPS, nb, bins);
    __syncthreads();
    if (warp == 0) bins_exclusive(bins, nb, bexcl, lane);
    __syncthreads();
    for (int j = wbeg + lane; j < wend; j += 32) {
      const int e = src ? src[j] : j;
      const unsigned d = digit(e);
      const unsigned b = (d >> lo) & (nb - 1);
      const int s = bexcl[b] + mine[b] + ranks[j];
      dst[s] = static_cast<unsigned short>(e);
      if (rounds == 1) sdig[s] = static_cast<D>(d);
    }
    __syncthreads();
  }
  if (rounds == 2) {
    for (int s = threadIdx.x; s < count; s += blockDim.x)
      sdig[s] = static_cast<D>(digit(order[s]));
    __syncthreads();
  }
}

// rstart[s] = the first slot of slot s's run of equal digits in the sorted
// sdig[0, count), by the whole block: a max-scan of the slots where the
// digit changes, over one contiguous chunk of slots per thread.  `tops`
// holds one int per warp.  The caller syncs before reading rstart.
template <typename D>
__device__ void run_starts(const D* sdig, int count, unsigned short* rstart,
                           int* tops) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (count + blockDim.x - 1) / blockDim.x;
  const int b = min(static_cast<int>(threadIdx.x) * per, count);
  const int e = min(b + per, count);
  int top = -1;
  for (int s = b; s < e; ++s)
    if (s == 0 || sdig[s] != sdig[s - 1]) top = s;
  int incl = top;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) tops[warp] = incl;
  int cur = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) cur = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) cur = max(cur, tops[w]);
  for (int s = b; s < e; ++s) {
    if (s == 0 || sdig[s] != sdig[s - 1]) cur = s;
    rstart[s] = static_cast<unsigned short>(cur);
  }
}
