// Tile multisplit: the port of repro/kernels/multisplit.py::_multisplit_kernel
// (keys) and ::_multisplit_kv_kernel (keys with values).
//
// Per (KPB,) tile the kernels return the keys stably reordered digit-major,
// each output slot's digit, its rank within its digit run, and the tile's
// (r,) histogram.  The TPU built a KPB x KPB permutation matrix per tile
// and applied it on the MXU in exact 16-bit halves; here the result is
// computed directly.  One CTA per tile:
//   1. per-warp digit counts over contiguous warp slices (common.cuh's
//      stable in-block rank, shared with csrc/fused_pass.cu);
//   2. exclusive offsets across warps, the histogram (stored), and the run
//      starts by a warp scan over the r digits;
//   3. a second walk ranks every key stably within its digit and stages
//      key, digit (and value) at run start + rank in shared memory;
//   4. the staged digit-major tile is written out coalesced, with
//      rank = slot - run start of its digit.
// Keys are read twice (the second walk mostly from L2); nothing is
// scattered to device memory.
//
// The reference rebuilt keys and values from ceil(bits / 16) 16-bit halves,
// so only their low 16 * ceil(key_bits / 16) (val_bits) bits survive: the
// wrapper passes those masks.  Digits use the key dtype's own shift.
//
// Bound: bytes.  Keys read once (n·kb), keys, digits and ranks written
// (n·(kb + 4 + 4)), T·r·4 of histograms; plus 2·n·vb for values.
// KPB·(kb + vb + 1) + 68·r bytes of shared memory must fit 227 KB.
#include "common.cuh"

constexpr int kSplitThreads = 512;
constexpr int kSplitWarps = kSplitThreads / 32;

__host__ __device__ inline size_t split_align(size_t bytes) {
  return (bytes + 7) / 8 * 8;
}

template <typename K, typename V, bool KV>
__global__ void __launch_bounds__(kSplitThreads)
multisplit_kernel(const K* __restrict__ keys, const V* __restrict__ vals,
                  K* __restrict__ out_keys, V* __restrict__ out_vals,
                  int* __restrict__ out_digit, int* __restrict__ out_rank,
                  int* __restrict__ out_hist, int kpb, int shift, int width,
                  int logical, K key_mask, V val_mask) {
  extern __shared__ unsigned long long smem_raw[];
  unsigned char* at = reinterpret_cast<unsigned char*>(smem_raw);
  K* sk = reinterpret_cast<K*>(at);                      // (kpb,) staged keys
  at += split_align(sizeof(K) * kpb);
  V* sv = reinterpret_cast<V*>(at);                      // (kpb,) staged vals
  if (KV) at += split_align(sizeof(V) * kpb);
  int* wcnt = reinterpret_cast<int*>(at);                // (warps, r)
  const int r = 1 << width;
  int* run = wcnt + kSplitWarps * r;                     // (r,) run starts
  uint8_t* sd = reinterpret_cast<uint8_t*>(run + r);     // (kpb,) digits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kpb;
  for (int i = tid; i < kSplitWarps * r; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();

  // 1. per-warp digit counts over the warp's contiguous slice
  const int per = warp_slice_per(kpb, kSplitWarps);
  const int wbeg = warp * per;
  const int wend = min(wbeg + per, kpb);
  int* mine = wcnt + warp * r;
  for (int b = wbeg; b < wend; b += 32) {
    const int i = b + lane;
    const bool valid = i < wend;
    const unsigned d =
        valid ? digit_at(keys[base + i], shift, width, logical) : 0u;
    warp_count_step(mine, d, valid, lane);
  }
  __syncthreads();

  // 2. offsets across warps; histogram and run starts (warp 0 scans the
  //    r digit counts, each lane a contiguous range of them)
  warps_exclusive(wcnt, kSplitWarps, r, run);
  __syncthreads();
  if (warp == 0) {
    const int each = (r + 31) / 32;                 // digits per lane
    const int d0 = min(lane * each, r), d1 = min(d0 + each, r);
    int own = 0;
    for (int d = d0; d < d1; ++d) own += run[d];
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += up;
    }
    int acc = incl - own;
    int* hist = out_hist + static_cast<long long>(blockIdx.x) * r;
    for (int d = d0; d < d1; ++d) {
      const int c = run[d];
      hist[d] = c;
      run[d] = acc;
      acc += c;
    }
  }
  __syncthreads();

  // 3. stable rank within the digit; stage the tile digit-major
  for (int b = wbeg; b < wend; b += 32) {
    const int i = b + lane;
    const bool valid = i < wend;
    K key = 0;
    unsigned d = 0;
    if (valid) {
      key = keys[base + i];
      d = digit_at(key, shift, width, logical);
    }
    const int rank = warp_rank_step(mine, d, valid, lane);
    if (valid) {
      const int dest = run[d] + rank;
      sk[dest] = static_cast<K>(key & key_mask);
      sd[dest] = static_cast<uint8_t>(d);
      if (KV) sv[dest] = static_cast<V>(vals[base + i] & val_mask);
    }
  }
  __syncthreads();

  // 4. coalesced write of the digit-major tile
  for (int j = tid; j < kpb; j += blockDim.x) {
    const int d = sd[j];
    out_keys[base + j] = sk[j];
    out_digit[base + j] = d;
    out_rank[base + j] = j - run[d];
    if (KV) out_vals[base + j] = sv[j];
  }
}

REPRO_ERROR_STRING

constexpr size_t kSplitSmemLimit = 232448;

template <typename K, typename V, bool KV>
static int launch_split(const void* keys, const void* vals, void* out_keys,
                        void* out_vals, int* out_digit, int* out_rank,
                        int* out_hist, int tiles, int kpb, int shift,
                        int width, int logical, unsigned long long key_mask,
                        unsigned long long val_mask, cudaStream_t s) {
  const int r = 1 << width;
  const size_t shmem = split_align(sizeof(K) * kpb) +
                       (KV ? split_align(sizeof(V) * kpb) : 0) +
                       sizeof(int) * (kSplitWarps + 1) * r + kpb;
  if (shmem > kSplitSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      multisplit_kernel<K, V, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  multisplit_kernel<K, V, KV><<<tiles, kSplitThreads, shmem, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals),
      static_cast<K*>(out_keys), static_cast<V*>(out_vals), out_digit,
      out_rank, out_hist, kpb, shift, width, logical,
      static_cast<K>(key_mask), static_cast<V>(val_mask));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
static int split_by_value(int val_bytes, const void* keys, const void* vals,
                          void* out_keys, void* out_vals, int* out_digit,
                          int* out_rank, int* out_hist, int tiles, int kpb,
                          int shift, int width, int logical,
                          unsigned long long key_mask,
                          unsigned long long val_mask, cudaStream_t s) {
  switch (val_bytes) {
    case 0: return launch_split<K, uint8_t, false>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, s);
    case 2: return launch_split<K, uint16_t, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, s);
    case 4: return launch_split<K, uint32_t, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, s);
    case 8: return launch_split<K, unsigned long long, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, s);
    default: return cudaErrorInvalidValue;
  }
}

// (tiles, kpb) keys [and values] -> digit-major keys [values], digits,
// ranks (tiles, kpb) and histograms (tiles, 2^width).  val_bytes 0: keys
// only (vals, out_vals null).  Keys of 2, 4 or 8 bytes.
extern "C" int tile_multisplit_launch(
    const void* keys, const void* vals, void* out_keys, void* out_vals,
    void* out_digit, void* out_rank, void* out_hist, int key_bytes,
    int val_bytes, int tiles, int kpb, int shift, int width, int logical,
    unsigned long long key_mask, unsigned long long val_mask, void* stream) {
  if (width < 1 || width > 8 || tiles < 1 || kpb < 1 || key_bytes == 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* dg = static_cast<int*>(out_digit);
  int* rk = static_cast<int*>(out_rank);
  int* hs = static_cast<int*>(out_hist);
  REPRO_DISPATCH_KEY(key_bytes, K,
    return split_by_value<K>(val_bytes, keys, vals, out_keys, out_vals, dg,
                             rk, hs, tiles, kpb, shift, width, logical,
                             key_mask, val_mask, s))
  return cudaErrorInvalidValue;
}
