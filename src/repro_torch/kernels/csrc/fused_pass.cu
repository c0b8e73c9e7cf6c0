// One whole counting pass in one launch: the port of
// repro/kernels/fused.py::_fused_pass_kernel.
//
// Per flat descriptor row (seg, off, reset, count, active) one CTA:
//   1. loads the row's keys into shared memory (the pass's one key read) and
//      counts their digits per warp; each warp owns a contiguous slice;
//   2. turns the per-warp counts into exclusive offsets across warps, so the
//      warp-then-lane order of the walk below is the keys' index order;
//   3. obtains its in-segment carry by decoupled look-back over the CTAs of
//      earlier rows of the same region (below);
//   4. walks its slice again 32 keys at a time, in order: __match_any_sync
//      gives each lane its rank among equal digits of the step, a running
//      per-warp digit counter the rest, so the rank is stable (the stable
//      in-block rank of common.cuh, shared with csrc/multisplit.cu);
//   5. scatters key and every value leaf to
//        base_excl[seg, digit] + carry[digit] + rank   (partition rows),
//      and copy-through rows (active == 0) copy key and values to their own
//      index; lanes past `count` write nothing;
//   6. counts the next pass's digit at (nlo, nwidth), keyed by
//      next_sid[seg * r + digit], into `hist` (and at (n2lo, n2width) into
//      `hist2` with lookahead), warp-aggregated global atomics.
//
// The TPU ran the grid in order and carried the in-segment offsets in
// scratch.  CTAs here run concurrently and in no order, so each CTA takes a
// virtual row id from a global ticket (every row it may wait on has then
// already started: no deadlock), publishes its block histogram at once
// (flag 1), walks back over the published rows of its region adding their
// aggregates until it meets an inclusive prefix (flag 2), and publishes its
// own inclusive prefix.  The first row of a region (reset == 1) starts from
// zero and publishes its inclusive prefix directly.  Rows are stable
// partitions in descriptor order, so the output is byte-identical to the
// reference's sequential carry.
//
// Bound: bytes.  Keys 1R + 1W, every value leaf 1R + 1W, plus the small
// descriptor tables and the two (a_max * r) histograms.  The scatter is
// per lane (no shared-memory write combining yet), which costs write
// efficiency on short digit runs.  Supports d <= 8 (r <= 256), kpb <= 2^16
// and up to kMaxLeaves value leaves of 1, 2, 4 or 8 bytes.
#include "common.cuh"

constexpr int kPassThreads = 512;
constexpr int kPassWarps = kPassThreads / 32;
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

__device__ __forceinline__ int load_flag(const int* flag) {
  return *reinterpret_cast<const volatile int*>(flag);
}

template <typename K>
__global__ void __launch_bounds__(kPassThreads)
fused_pass_kernel(const K* __restrict__ src_keys, K* __restrict__ dst_keys,
                  Leaves leaves, const int* __restrict__ blk_seg,
                  const int* __restrict__ blk_off,
                  const int* __restrict__ blk_reset,
                  const int* __restrict__ blk_count,
                  const int* __restrict__ blk_active, int rows,
                  const int* __restrict__ base_excl,
                  const int* __restrict__ next_sid, int lo, int width,
                  int nlo, int nwidth, int n2lo, int n2width, int lookahead,
                  int r, int a_max, int kpb, int* hist, int* hist2,
                  int* ticket, int* flags, int* agg, int* incl) {
  extern __shared__ unsigned long long smem_raw[];
  K* skeys = reinterpret_cast<K*>(smem_raw);                // (kpb,)
  int* wcnt = reinterpret_cast<int*>(                        // (warps, r)
      reinterpret_cast<unsigned char*>(smem_raw) +
      (static_cast<size_t>(kpb) * sizeof(K) + 7) / 8 * 8);
  int* carry = wcnt + kPassWarps * r;                        // (r,)
  int* bhist = carry + r;                                    // (r,)
  __shared__ int s_row;

  if (threadIdx.x == 0) s_row = atomicAdd(ticket, 1);
  __syncthreads();
  const int g = s_row;
  if (g >= rows) return;
  const int count = blk_count[g];
  if (count <= 0) return;
  const long long off = blk_off[g];
  const int tid = threadIdx.x;

  if (!blk_active[g]) {                 // copy-through row: own index
    for (int i = tid; i < count; i += blockDim.x) {
      dst_keys[off + i] = src_keys[off + i];
      for (int v = 0; v < leaves.count; ++v)
        copy_elem(leaves.src[v], leaves.dst[v], leaves.bytes[v], off + i,
                  off + i);
    }
    return;
  }

  const int seg = blk_seg[g];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kPassWarps * r; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();

  // 1. load + per-warp digit counts over the warp's contiguous slice
  const int per = warp_slice_per(count, kPassWarps);
  const int wbeg = warp * per;
  const int wend = min(wbeg + per, count);
  int* mine = wcnt + warp * r;
  for (int base = wbeg; base < wend; base += 32) {
    const int i = base + lane;
    const bool valid = i < wend;
    unsigned d = 0;
    if (valid) {
      const K key = src_keys[off + i];
      skeys[i] = key;
      d = digit_at(key, lo, width, true);
    }
    warp_count_step(mine, d, valid, lane);
  }
  __syncthreads();

  // 2. exclusive offsets across warps per digit; block histogram
  warps_exclusive(wcnt, kPassWarps, r, bhist);
  __syncthreads();

  // 3. in-segment carry by decoupled look-back in descriptor order
  const long long row_off = static_cast<long long>(g) * r;
  if (blk_reset[g]) {
    for (int d = tid; d < r; d += blockDim.x) {
      carry[d] = 0;
      incl[row_off + d] = bhist[d];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flags + g, 2);
  } else {
    for (int d = tid; d < r; d += blockDim.x) agg[row_off + d] = bhist[d];
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flags + g, 1);
    for (int d = tid; d < r; d += blockDim.x) {
      int acc = 0;
      for (int j = g - 1;; --j) {
        int f;
        while ((f = load_flag(flags + j)) == 0) {
        }
        __threadfence();
        const long long at = static_cast<long long>(j) * r + d;
        if (f == 2) {
          acc += __ldcg(incl + at);
          break;
        }
        acc += __ldcg(agg + at);
      }
      carry[d] = acc;
      incl[row_off + d] = acc + bhist[d];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flags + g, 2);
  }

  // 4-6. stable rank, scatter, next-pass histograms
  const int* bex = base_excl + static_cast<long long>(seg) * r;
  const int* nsid = next_sid + static_cast<long long>(seg) * r;
  for (int base = wbeg; base < wend; base += 32) {
    const int i = base + lane;
    const bool valid = i < wend;
    K key = 0;
    unsigned d = 0;
    if (valid) {
      key = skeys[i];
      d = digit_at(key, lo, width, true);
    }
    const int rank = warp_rank_step(mine, d, valid, lane);
    int bin = -1, bin2 = -1;
    if (valid) {
      const long long dest = static_cast<long long>(bex[d]) + carry[d] +
                             rank;
      dst_keys[dest] = key;
      for (int v = 0; v < leaves.count; ++v)
        copy_elem(leaves.src[v], leaves.dst[v], leaves.bytes[v], off + i,
                  dest);
      const int sid = nsid[d];
      if (sid < a_max) {
        if (nwidth > 0) bin = sid * r + digit_at(key, nlo, nwidth, true);
        if (lookahead && n2width > 0)
          bin2 = sid * r + digit_at(key, n2lo, n2width, true);
      }
    }
    warp_count(hist, bin, lane);
    if (lookahead) warp_count(hist2, bin2, lane);
  }
}

REPRO_ERROR_STRING

// One fused pass over `rows` flat descriptor rows.  `state` is a zeroed
// int32 scratch of (1 + rows) ints (ticket, then one flag per row); agg and
// incl are (rows * r,) int32 scratch that need no clearing.  hist (and hist2
// when lookahead) are zeroed (a_max * r,) int32 outputs.
extern "C" int fused_pass_launch(
    const void* src_keys, void* dst_keys, int key_bytes,
    const void* const* val_src, void* const* val_dst, const int* val_bytes,
    int num_vals, const int* blk_seg, const int* blk_off,
    const int* blk_reset, const int* blk_count, const int* blk_active,
    int rows, const int* base_excl, const int* next_sid, int lo, int width,
    int nlo, int nwidth, int n2lo, int n2width, int lookahead, int r,
    int a_max, int kpb, void* hist, void* hist2, void* state, void* agg,
    void* incl, void* stream) {
  if (r < 2 || r > 256 || num_vals < 0 || num_vals > kMaxLeaves || rows < 1 ||
      kpb < 1 || kpb > 65536)
    return cudaErrorInvalidValue;
  Leaves leaves{};
  leaves.count = num_vals;
  for (int v = 0; v < num_vals; ++v) {
    leaves.src[v] = val_src[v];
    leaves.dst[v] = val_dst[v];
    leaves.bytes[v] = val_bytes[v];
  }
  const size_t key_smem = (static_cast<size_t>(kpb) * key_bytes + 7) / 8 * 8;
  const size_t shmem = key_smem + sizeof(int) * (kPassWarps + 2) * r;
  int* st = static_cast<int*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KEY(key_bytes, K, {
    cudaError_t e = cudaFuncSetAttribute(
        fused_pass_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_pass_kernel<K><<<rows, kPassThreads, shmem, s>>>(
        static_cast<const K*>(src_keys), static_cast<K*>(dst_keys), leaves,
        blk_seg, blk_off, blk_reset, blk_count, blk_active, rows, base_excl,
        next_sid, lo, width, nlo, nwidth, n2lo, n2width, lookahead, r, a_max,
        kpb, static_cast<int*>(hist), static_cast<int*>(hist2), st, st + 1,
        static_cast<int*>(agg), static_cast<int*>(incl));
  })
  return static_cast<int>(cudaGetLastError());
}
