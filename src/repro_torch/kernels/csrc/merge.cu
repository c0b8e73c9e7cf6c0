// One k-way merge round in one launch: the port of
// repro/kernels/merge.py::_kway_merge_kernel (launched by kway_merge_round),
// redesigned for the H100.
//
// One CTA per output tile g (a persistent grid walking the tiles measured
// slower on the H100: PERF.md).  The host picks one of two kernels per
// round.  A round of short tiles (kway * tpb <= kSmallMerge), of tiles
// wider than the tree holds (tpb > kTreeMax), or whose output table does
// not fit next to the staged windows runs merge_small (below); any other,
// kway_merge_kernel:
//   1. loads its own descriptors: out_off[g], out_cnt[g] and, per run r of
//      the kway, the window start win_start[g*kway + r] and live lane count
//      win_take[g*kway + r] (the TPU kernel had them scalar-prefetched);
//   2. stages the live prefix of every window (keys only) in shared memory,
//      back to back: run r at [excl_r, excl_r + take_r);
//   3. merges the staged runs under (key, run, lane) order in shared
//      memory by a tree of stable 2-way merges (tree_merge: per level one
//      merge-path search per thread, then one compare and one shared load
//      per output), carrying each key's staged slot: the tile's output
//      table (write combining, the paper's §4.4);
//   4. writes the tile's outputs [0, min(out_cnt, live)) with 16-byte
//      vector stores: each key read from its staged slot, each value leaf
//      gathered from src_leaf[win_start_r + j] (the staged slot names run
//      and lane) in global memory (an L2 prefetch of the tile's value
//      windows measured no faster).
// The union of a tile's live lanes is exactly its out_cnt <= tpb outputs
// (both planners' tables: merge_path_partition, spill_group_plan), so
// every output slot of [0, n) is written once and the tree's table of tpb
// slots holds every live lane; the tree kernel caps a tile's live lanes
// at tpb, so a table that breaks this cannot write past the tile.  A lane
// whose rank is not below out_cnt writes nothing (the TPU kernel sent it
// to the trash slot n); dead tiles (out_cnt == 0, the zero-count padding
// of a spill strip) are skipped.
//
// Bound: bytes.  A round reads every key and value once and writes them
// once, 2 * n_pad * (kb + vb) (ANALYSIS_CONTRACTS["ooc_merge_round"],
// repro/core/outofcore.py:1218), plus the small tables: 2^30 keys with a
// 4-byte value are 16 GiB, 5.1 ms at 3.35 TB/s.  What held the first
// version back: every lane stored its key and value scattered over the
// tile's span, each element did kway - 1 full binary searches (36 shared
// loads at kway 4, a divergent chain each).  The tree merges by 2-way
// merge paths (about one shared load and one compare per output and
// level) and writes whole 16-byte vectors in output order.
// Shared memory per CTA: the 16-byte-aligned tables + kway * tpb * key
// bytes (rounded up to 16), plus for the tree tpb 2-byte output slots; the
// wrapper refuses windows over the 227 KB opt-in limit.  Keys of 1, 2, 4
// or 8 bytes (read as unsigned: the carrier's bits), up to kMaxLeaves
// value leaves of 1, 2, 4 or 8 bytes.
#include "common.cuh"

constexpr int kMergeThreads = 256;
constexpr int kMaxLeaves = 8;
// outputs a thread merges per level of the tree (odd: see tree_merge),
// and the widest tile the tree merges
constexpr int kTreeSpan = 17;
constexpr int kTreeMax = kMergeThreads * kTreeSpan;
// a staged slot of the tree's output table (tpb <= kTreeMax)
using Slot = uint16_t;
// tiles of at most this many staged keys (kway * tpb) run merge_small
constexpr long long kSmallMerge = 4096;

struct Leaves {
  const void* src[kMaxLeaves];
  void* dst[kMaxLeaves];
  int bytes[kMaxLeaves];
  int count;
};

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ inline size_t table_bytes(int kway) {
  return align16(sizeof(int) * (3 * kway + 1));
}

// Whether `a` comes before `key`: a <= key for an earlier run (upper),
// a < key for a later one.
template <typename K>
__device__ __forceinline__ bool before(K a, K key, bool upper) {
  return upper ? !(key < a) : a < key;
}

// Number of a[0, len) before `key`: a binary search.
template <typename K>
__device__ __forceinline__ int count_before(const K* a, int len, K key,
                                            bool upper) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(a[mid], key, upper)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The tile's staged runs merged in place by a tree of stable 2-way merges:
// level w merges runs [g, g + w) (left) with [g + w, g + 2w), ties to the
// left, so the result is in (key, run, lane) order.  Thread t merges the
// level's outputs [t * span, (t + 1) * span): one binary search for the
// merge path of its first output (the split between left and right), then
// one compare and one shared load per output, holding its outputs in
// registers until every thread has read the level.  The span is odd, so a
// warp's lanes read at an odd stride: distinct banks.  On return win[o] is
// output o's key and out[o] its staged slot, for o < total (<= kTreeMax).
template <typename K>
__device__ void tree_merge(K* win, Slot* out, const int* s_excl, int kway,
                           int total) {
  const int threads = blockDim.x;
  const int span = min(kTreeSpan, ((total + threads - 1) / threads) | 1);
  const int o0 = threadIdx.x * span, o1 = min(o0 + span, total);
  for (int e = threadIdx.x; e < total; e += threads)
    out[e] = static_cast<Slot>(e);
  __syncthreads();
  for (int w = 1; w < kway; w <<= 1) {
    K ok[kTreeSpan];
    Slot os[kTreeSpan];
    int a0 = 0, a1 = 0, a2 = 0, i = 0, j = 0;   // the merge of output o
    K lk = 0, rk = 0;                            // its two heads
    int o = o0;
#pragma unroll
    for (int k = 0; k < kTreeSpan; ++k) {
      if (o < o1) {
        if (o >= a2) {                           // the merge holding o
          int g = 0;
          while (s_excl[min(g + 2 * w, kway)] <= o) g += 2 * w;
          a0 = s_excl[g];
          a1 = s_excl[min(g + w, kway)];
          a2 = s_excl[min(g + 2 * w, kway)];
          const int d = o - a0;
          int lo = max(0, d - (a2 - a1)), hi = min(d, a1 - a0);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (!(win[a1 + d - 1 - mid] < win[a0 + mid])) lo = mid + 1;
            else hi = mid;
          }
          i = lo;
          j = d - lo;
          if (a0 + i < a1) lk = win[a0 + i];
          if (a1 + j < a2) rk = win[a1 + j];
        }
        const bool left = a1 + j >= a2 || (a0 + i < a1 && !(rk < lk));
        ok[k] = left ? lk : rk;
        os[k] = out[left ? a0 + i : a1 + j];
        if (left) {
          if (a0 + ++i < a1) lk = win[a0 + i];
        } else {
          if (a1 + ++j < a2) rk = win[a1 + j];
        }
        ++o;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTreeSpan; ++k)
      if (o0 + k < o1) {
        win[o0 + k] = ok[k];
        out[o0 + k] = os[k];
      }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          long long from, long long to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

__device__ __forceinline__ void copy_any(const void* src, void* dst,
                                         int bytes, long long from,
                                         long long to) {
  switch (bytes) {
    case 1: copy_elem<uint8_t>(src, dst, from, to); break;
    case 2: copy_elem<uint16_t>(src, dst, from, to); break;
    case 4: copy_elem<uint32_t>(src, dst, from, to); break;
    default: copy_elem<unsigned long long>(src, dst, from, to);
  }
}

// One value leaf of the tile's m outputs: output o gathers its source
// through the staged slot out[o] (run r: src[start_r + slot - excl_r]).
template <typename T>
__device__ void move_leaf(const void* src, void* dst, long long out0, int m,
                          const Slot* out, const int* s_start,
                          const int* s_excl, int kway) {
  const T* s = static_cast<const T*>(src);
  store_run<T>(static_cast<T*>(dst) + out0, m, [&](int o) {
    const int slot = min(static_cast<int>(out[o]), s_excl[kway] - 1);
    int r = 0;
    while (r + 1 < kway && slot >= s_excl[r + 1]) ++r;
    return s[static_cast<long long>(s_start[r]) + slot - s_excl[r]];
  });
}

template <typename K>
__global__ void __launch_bounds__(kMergeThreads)
kway_merge_kernel(const K* __restrict__ src_keys, K* __restrict__ dst_keys,
                  Leaves leaves, const int* __restrict__ out_off,
                  const int* __restrict__ out_cnt,
                  const int* __restrict__ win_start,
                  const int* __restrict__ win_take, int kway, int tpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_start = reinterpret_cast<int*>(smem);
  int* s_take = s_start + kway;
  int* s_excl = s_take + kway;                       // kway + 1 entries
  K* win = reinterpret_cast<K*>(smem + table_bytes(kway));
  Slot* out = reinterpret_cast<Slot*>(
      smem + table_bytes(kway) +
      align16(sizeof(K) * static_cast<size_t>(kway) * tpb));
  const int tid = threadIdx.x;

  const int g = blockIdx.x;
  const int cnt = out_cnt[g];
  if (cnt <= 0) return;                            // a dead tile
  const long long out0 = out_off[g];
  if (tid < kway) {
    const long long base = static_cast<long long>(g) * kway + tid;
    s_start[tid] = win_start[base];
    s_take[tid] = min(max(win_take[base], 0), tpb);
  }
  __syncthreads();
  if (tid == 0) {                                  // at most tpb live lanes
    int acc = 0;
    for (int r = 0; r < kway; ++r) {
      s_take[r] = min(s_take[r], tpb - acc);
      s_excl[r] = acc;
      acc += s_take[r];
    }
    s_excl[kway] = acc;
  }
  __syncthreads();
  const int total = s_excl[kway];

  // 2. stage the live prefixes back to back, four loads in flight
  for (int e0 = tid; e0 < total; e0 += 4 * blockDim.x) {
    K k[4];
    int r = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) {
        while (e >= s_excl[r + 1]) ++r;
        k[u] = src_keys[static_cast<long long>(s_start[r]) + e -
                        s_excl[r]];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * blockDim.x < total) win[e0 + u * blockDim.x] = k[u];
  }
  __syncthreads();

  // 3. the merge
  tree_merge<K>(win, out, s_excl, kway, total);

  // 4. the tile's outputs in order, 16 bytes per store
  const int m = min(cnt, total);
  store_run<K>(dst_keys + out0, m, [&](int o) { return win[o]; });
  for (int v = 0; v < leaves.count; ++v) {
    const void* src = leaves.src[v];
    void* dst = leaves.dst[v];
    switch (leaves.bytes[v]) {
      case 1: move_leaf<uint8_t>(src, dst, out0, m, out, s_start, s_excl,
                                 kway); break;
      case 2: move_leaf<uint16_t>(src, dst, out0, m, out, s_start, s_excl,
                                  kway); break;
      case 4: move_leaf<uint32_t>(src, dst, out0, m, out, s_start, s_excl,
                                  kway); break;
      default: move_leaf<unsigned long long>(src, dst, out0, m, out, s_start,
                                             s_excl, kway);
    }
  }
}

// A short tile (kway * tpb <= kSmallMerge: tiles up to 1024 at kway 4,
// oocsort's default 256 among them), or one the tree cannot take: the
// first version's per-lane rank and scatter, which needs no table and few
// registers, so many CTAs per SM hide the latency of a tile's few loads
// (measured faster there than the tree, slower at tile 4096: PERF.md).
// Each live element's rank is its lane plus a binary search per other run;
// the key and each value leaf go straight to out_off + rank.
template <typename K>
__global__ void __launch_bounds__(kMergeThreads)
merge_small(const K* __restrict__ src_keys, K* __restrict__ dst_keys,
            Leaves leaves, const int* __restrict__ out_off,
            const int* __restrict__ out_cnt,
            const int* __restrict__ win_start,
            const int* __restrict__ win_take, int kway, int tpb) {
  const int g = blockIdx.x;
  const int cnt = out_cnt[g];
  if (cnt <= 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_start = reinterpret_cast<int*>(smem);
  int* s_take = s_start + kway;
  int* s_excl = s_take + kway;                       // kway + 1 entries
  K* win = reinterpret_cast<K*>(smem + table_bytes(kway));
  const long long base = static_cast<long long>(g) * kway;
  for (int r = threadIdx.x; r < kway; r += blockDim.x) {
    s_start[r] = win_start[base + r];
    s_take[r] = min(max(win_take[base + r], 0), tpb);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = 0; r < kway; ++r) {
      s_excl[r] = acc;
      acc += s_take[r];
    }
    s_excl[kway] = acc;
  }
  __syncthreads();
  const int total = s_excl[kway];
  for (int e = threadIdx.x, r = 0; e < total; e += blockDim.x) {
    while (e >= s_excl[r + 1]) ++r;
    const int j = e - s_excl[r];
    win[r * tpb + j] = src_keys[static_cast<long long>(s_start[r]) + j];
  }
  __syncthreads();
  const long long out0 = out_off[g];
  for (int e = threadIdx.x, r = 0; e < total; e += blockDim.x) {
    while (e >= s_excl[r + 1]) ++r;
    const int j = e - s_excl[r];
    const K key = win[r * tpb + j];
    int rank = j;
    for (int q = 0; q < r; ++q)
      rank += count_before(win + q * tpb, s_take[q], key, true);
    for (int q = r + 1; q < kway; ++q)
      rank += count_before(win + q * tpb, s_take[q], key, false);
    if (rank >= cnt) continue;
    const long long to = out0 + rank;
    const long long from = static_cast<long long>(s_start[r]) + j;
    dst_keys[to] = key;
    for (int v = 0; v < leaves.count; ++v)
      copy_any(leaves.src[v], leaves.dst[v], leaves.bytes[v], from, to);
  }
}

REPRO_ERROR_STRING

constexpr long long kSmemLimit = 232448;

// Shared memory of one CTA: the tables and the staged windows (what
// merge_small needs; the wrapper's check) and the tree's output table.
static long long windows_smem(int kway, int tpb, int key_bytes) {
  return static_cast<long long>(table_bytes(kway)) +
         static_cast<long long>(
             align16(static_cast<size_t>(kway) * tpb * key_bytes));
}

static long long tree_smem(int kway, int tpb, int key_bytes) {
  return windows_smem(kway, tpb, key_bytes) +
         static_cast<long long>(align16(sizeof(Slot) * tpb));
}

// One round: `tiles` (G) output tiles over flat (G,) / (G * kway,) tables.
// force: 0 picks the kernel as above; 1 runs merge_small and 2 the tree
// whatever the tile (kway_merge_probe, for timing only: a round the tree
// cannot take is refused).
static int merge_round(const void* src_keys, void* dst_keys, int key_bytes,
                       const void* const* val_src, void* const* val_dst,
                       const int* val_bytes, int num_vals,
                       const int* out_off, const int* out_cnt,
                       const int* win_start, const int* win_take, int tiles,
                       int kway, int tpb, int force, cudaStream_t s) {
  if (tiles < 1 || kway < 1 || tpb < 1 || num_vals < 0 ||
      num_vals > kMaxLeaves || force < 0 || force > 2)
    return cudaErrorInvalidValue;
  Leaves leaves{};
  leaves.count = num_vals;
  for (int v = 0; v < num_vals; ++v) {
    leaves.src[v] = val_src[v];
    leaves.dst[v] = val_dst[v];
    leaves.bytes[v] = val_bytes[v];
  }
  const bool tree_fits = tpb <= kTreeMax &&
                         tree_smem(kway, tpb, key_bytes) <= kSmemLimit;
  if (force == 2 && !tree_fits) return cudaErrorInvalidValue;
  const bool tree =
      force == 2 ||
      (force == 0 && tree_fits &&
       static_cast<long long>(kway) * tpb > kSmallMerge);
  const long long shmem = tree ? tree_smem(kway, tpb, key_bytes)
                               : windows_smem(kway, tpb, key_bytes);
  if (shmem > kSmemLimit) return cudaErrorInvalidValue;
  REPRO_DISPATCH_KEY(key_bytes, K, {
    auto kernel_fn = tree ? kway_merge_kernel<K> : merge_small<K>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel_fn<<<tiles, kMergeThreads, shmem, s>>>(
        static_cast<const K*>(src_keys), static_cast<K*>(dst_keys), leaves,
        out_off, out_cnt, win_start, win_take, kway, tpb);
    return static_cast<int>(cudaGetLastError());
  })
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int kway_merge_launch(const void* src_keys, void* dst_keys,
                                 int key_bytes, const void* const* val_src,
                                 void* const* val_dst, const int* val_bytes,
                                 int num_vals, const int* out_off,
                                 const int* out_cnt, const int* win_start,
                                 const int* win_take, int tiles, int kway,
                                 int tpb, void* stream) {
  return merge_round(src_keys, dst_keys, key_bytes, val_src, val_dst, val_bytes,
               num_vals, out_off, out_cnt, win_start, win_take, tiles, kway,
               tpb, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int kway_merge_probe(const void* src_keys, void* dst_keys,
                                int key_bytes, const void* const* val_src,
                                void* const* val_dst, const int* val_bytes,
                                int num_vals, const int* out_off,
                                const int* out_cnt, const int* win_start,
                                const int* win_take, int tiles, int kway,
                                int tpb, int force, void* stream) {
  return merge_round(src_keys, dst_keys, key_bytes, val_src, val_dst, val_bytes,
               num_vals, out_off, out_cnt, win_start, win_take, tiles, kway,
               tpb, force, static_cast<cudaStream_t>(stream));
}
