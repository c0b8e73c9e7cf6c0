// One k-way merge round in one launch: the port of
// repro/kernels/merge.py::_kway_merge_kernel (launched by kway_merge_round).
//
// One CTA per output tile g of a merge group.  The CTA
//   1. loads its own descriptors: out_off[g], out_cnt[g] and, per run r of
//      the kway, the window start win_start[g*kway + r] and live lane count
//      win_take[g*kway + r] (the TPU kernel had them scalar-prefetched);
//   2. stages the live prefix of every window (keys only) in shared memory,
//      window r at [r * tpb, r * tpb + take_r);
//   3. ranks every live element (r, j) under (key, run, lane) order: its
//      lane j, plus per earlier run the keys <= it (upper bound), plus per
//      later run the keys < it (lower bound), each a binary search over that
//      run's staged prefix;
//   4. writes the key to dst[out_off + rank] and gathers every value leaf
//      from src_leaf[win_start_r + j] in global memory to the same slot.
// The union of a tile's live lanes is exactly its out_cnt outputs, so every
// output slot of [0, n) is written once.  A lane whose rank is not below
// out_cnt writes nothing (the TPU kernel sent it to the trash slot n); dead
// tiles (out_cnt == 0, the zero-count padding of a spill strip) exit at once.
//
// Bound: bytes.  A round reads every key and value once and writes them
// once, 2 * n_pad * (kb + vb) (ANALYSIS_CONTRACTS["ooc_merge_round"],
// repro/core/outofcore.py:1218), plus the small tables: 2^30 keys with a
// 4-byte value are 16 GiB, 5.1 ms at 3.35 TB/s.  The design reads keys
// coalesced into shared memory and values once each; what it gives away
// against the bound is the per-lane scatter of keys and values (each tile's
// writes land in one contiguous out_cnt-sized span, so L2 merges most of
// them) and kway - 1 shared-memory binary searches per element.
// Shared memory per CTA: kway * tpb * key bytes + 4 * (3 * kway + 1); the
// wrapper refuses more than the 227 KB opt-in limit.  Keys of 1, 2, 4 or 8
// bytes (read as unsigned: the carrier's bits), up to kMaxLeaves value
// leaves of 1, 2, 4 or 8 bytes.
#include "common.cuh"

constexpr int kMergeThreads = 256;
constexpr int kMaxLeaves = 8;

struct Leaves {
  const void* src[kMaxLeaves];
  void* dst[kMaxLeaves];
  int bytes[kMaxLeaves];
  int count;
};

__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int bytes, long long from,
                                          long long to) {
  switch (bytes) {
    case 1: static_cast<uint8_t*>(dst)[to] =
                static_cast<const uint8_t*>(src)[from]; break;
    case 2: static_cast<uint16_t*>(dst)[to] =
                static_cast<const uint16_t*>(src)[from]; break;
    case 4: static_cast<uint32_t*>(dst)[to] =
                static_cast<const uint32_t*>(src)[from]; break;
    default: static_cast<unsigned long long*>(dst)[to] =
                static_cast<const unsigned long long*>(src)[from]; break;
  }
}

// Number of a[0, len) that are < key (lower) or <= key (upper).
template <typename K, bool kUpper>
__device__ __forceinline__ int count_below(const K* a, int len, K key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = kUpper ? !(key < a[mid]) : (a[mid] < key);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__global__ void __launch_bounds__(kMergeThreads)
kway_merge_kernel(const K* __restrict__ src_keys, K* __restrict__ dst_keys,
                  Leaves leaves, const int* __restrict__ out_off,
                  const int* __restrict__ out_cnt,
                  const int* __restrict__ win_start,
                  const int* __restrict__ win_take, int kway, int tpb) {
  const int g = blockIdx.x;
  const int cnt = out_cnt[g];
  if (cnt <= 0) return;
  extern __shared__ unsigned long long smem_raw[];
  int* s_start = reinterpret_cast<int*>(smem_raw);
  int* s_take = s_start + kway;
  int* s_excl = s_take + kway;                       // kway + 1 entries
  const size_t table_bytes = (sizeof(int) * (3 * kway + 1) + 7) / 8 * 8;
  K* win = reinterpret_cast<K*>(reinterpret_cast<unsigned char*>(smem_raw) +
                                table_bytes);
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

  // stage the live prefixes: flat index e over the runs' live lanes
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
      rank += count_below<K, true>(win + q * tpb, s_take[q], key);
    for (int q = r + 1; q < kway; ++q)
      rank += count_below<K, false>(win + q * tpb, s_take[q], key);
    if (rank >= cnt) continue;
    const long long to = out0 + rank;
    const long long from = static_cast<long long>(s_start[r]) + j;
    dst_keys[to] = key;
    for (int v = 0; v < leaves.count; ++v)
      copy_elem(leaves.src[v], leaves.dst[v], leaves.bytes[v], from, to);
  }
}

REPRO_ERROR_STRING

// One round: grid = tiles (G) CTAs over flat (G,) / (G * kway,) tables.
extern "C" int kway_merge_launch(const void* src_keys, void* dst_keys,
                                 int key_bytes, const void* const* val_src,
                                 void* const* val_dst, const int* val_bytes,
                                 int num_vals, const int* out_off,
                                 const int* out_cnt, const int* win_start,
                                 const int* win_take, int tiles, int kway,
                                 int tpb, void* stream) {
  if (tiles < 1 || kway < 1 || tpb < 1 || num_vals < 0 ||
      num_vals > kMaxLeaves)
    return cudaErrorInvalidValue;
  Leaves leaves{};
  leaves.count = num_vals;
  for (int v = 0; v < num_vals; ++v) {
    leaves.src[v] = val_src[v];
    leaves.dst[v] = val_dst[v];
    leaves.bytes[v] = val_bytes[v];
  }
  const size_t table_bytes = (sizeof(int) * (3 * kway + 1) + 7) / 8 * 8;
  const size_t shmem = table_bytes + static_cast<size_t>(kway) * tpb * key_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    cudaError_t e = cudaFuncSetAttribute(
        kway_merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kway_merge_kernel<K><<<tiles, kMergeThreads, shmem, s>>>(
        static_cast<const K*>(src_keys), static_cast<K*>(dst_keys), leaves,
        out_off, out_cnt, win_start, win_take, kway, tpb);
  })
  return static_cast<int>(cudaGetLastError());
}
