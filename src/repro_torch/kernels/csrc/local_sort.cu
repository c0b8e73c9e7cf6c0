// Stable local sort of small buckets: the port of
// repro/kernels/bitonic.py::_bitonic_stable_kernel.
//
// The TPU kernel sorted a padded (S, L) table of (key, idx) rows held in
// VMEM.  Here one CTA sorts one row in shared memory with a bitonic network
// over (key, position) pairs; positions are distinct, so the lexicographic
// order is total and the result is exactly the reference's.  Two entries
// share the network:
//   * rows:     the (S, L) table contract of bitonic_sort_rows_stable;
//   * segments: the main path.  Row j of a size class reads its bucket
//     (start[j], size[j]) straight from the key buffer, pads to L in shared
//     memory (all-ones key, position n), sorts, writes the sorted keys back
//     in place and the source positions into perm[start..start+size) for
//     the value gather.  No padded table exists in device memory, so the
//     finish stays O(n) in memory and one read + one write of the keys
//     (R1).  Rows with size 0 (past the class's live count) exit at once.
//
// Bound: bytes at the main path's sizes — each key read once and written
// once (plus 4 bytes of perm per key with values); the network does
// O(L log^2 L) compares in shared memory, which is the cost to watch.
// L * (key bytes + 4) must fit the 227 KB opt-in shared memory.
#include "common.cuh"

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
__device__ __forceinline__ void smem_views(int len, K** keys, int** idx) {
  extern __shared__ unsigned long long smem_raw[];
  *keys = reinterpret_cast<K*>(smem_raw);
  *idx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem_raw) +
                                key_smem_bytes(len, sizeof(K)));
}

template <typename K>
__global__ void rows_kernel(const K* __restrict__ in_keys,
                            const int* __restrict__ in_idx,
                            K* __restrict__ out_keys, int* __restrict__ out_idx,
                            int len) {
  K* keys;
  int* idx;
  smem_views<K>(len, &keys, &idx);
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

template <typename K>
__global__ void segments_kernel(K* __restrict__ buf, int* __restrict__ perm,
                                const int* __restrict__ starts,
                                const int* __restrict__ sizes, int len,
                                int n) {
  const int size = sizes[blockIdx.x];
  if (size <= 0) return;
  const long long start = starts[blockIdx.x];
  K* keys;
  int* idx;
  smem_views<K>(len, &keys, &idx);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const bool live = j < size;
    keys[j] = live ? buf[start + j] : static_cast<K>(~K(0));
    idx[j] = live ? static_cast<int>(start + j) : n;
  }
  __syncthreads();
  bitonic_pairs(keys, idx, len);
  for (int j = threadIdx.x; j < size; j += blockDim.x) {
    buf[start + j] = keys[j];
    if (perm) perm[start + j] = idx[j];
  }
}

REPRO_ERROR_STRING

static int threads_for(int len) { return len >= 1024 ? 512 : (len / 2 > 32 ? len / 2 : 32); }

template <typename Kern>
static int prepare(Kern kernel, size_t shmem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem)));
}

// (S, L) rows of keys and int32 idx -> rows sorted by (key, idx).
extern "C" int sort_rows_launch(const void* keys, const void* idx,
                                void* out_keys, void* out_idx, int key_bytes,
                                int rows, int len, void* stream) {
  if (len < 2 || (len & (len - 1)) || rows < 1) return cudaErrorInvalidValue;
  const size_t shmem = key_smem_bytes(len, key_bytes) + sizeof(int) * len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    const int e = prepare(rows_kernel<K>, shmem);
    if (e) return e;
    rows_kernel<K><<<rows, threads_for(len), shmem, s>>>(
        static_cast<const K*>(keys), static_cast<const int*>(idx),
        static_cast<K*>(out_keys), static_cast<int*>(out_idx), len);
  })
  return static_cast<int>(cudaGetLastError());
}

// One size class: rows buckets (starts, sizes) of the key buffer, each at
// most len keys, sorted in place; perm (may be null) gets source positions.
extern "C" int sort_segments_launch(void* buf, void* perm, const int* starts,
                                    const int* sizes, int key_bytes, int rows,
                                    int len, int n, void* stream) {
  if (len < 2 || (len & (len - 1)) || rows < 1) return cudaErrorInvalidValue;
  const size_t shmem = key_smem_bytes(len, key_bytes) + sizeof(int) * len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    const int e = prepare(segments_kernel<K>, shmem);
    if (e) return e;
    segments_kernel<K><<<rows, threads_for(len), shmem, s>>>(
        static_cast<K*>(buf), static_cast<int*>(perm), starts, sizes, len, n);
  })
  return static_cast<int>(cudaGetLastError());
}
