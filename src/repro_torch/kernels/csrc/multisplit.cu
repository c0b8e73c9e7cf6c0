// Tile multisplit: the port of repro/kernels/multisplit.py::_multisplit_kernel
// (keys) and ::_multisplit_kv_kernel (keys with values).
//
// Per (KPB,) tile the kernels return the keys stably reordered digit-major,
// each output slot's digit, its rank within its digit run, and the tile's
// (r,) histogram.  The TPU built a KPB x KPB permutation matrix per tile
// and applied it on the MXU in exact 16-bit halves; here the result is
// computed directly, one CTA per tile.
//
// Bound: bytes.  Keys read once (n·kb), keys, digits and ranks written
// (n·(kb + 4 + 4)), T·r·4 of histograms; plus 2·n·vb for values.  What held
// the first version back on this card: the keys were read twice as scalar
// 4-byte loads, every key went through __match_any_sync twice (its cost
// grows with the distinct digits of a warp step), and every output was a
// scalar 4-byte store.  So, per tile:
//   1. the keys come into shared memory once, with 16-byte vector loads
//      (load_row: a scalar head and tail where the tile's start is not
//      16-byte aligned); thread 0 asks L2 for the tile's values at once;
//   2. stable_digit_order (common.cuh, shared with the fused pass's wide
//      variant) ranks the staged keys: per-warp digit bitmasks
//      (warp_mask_rank), offsets across warps, one placement walk: the
//      order is kept as a uint16 slot -> element table, the digits as one
//      byte per slot;
//   3. keys, digits and ranks go out in slot order as 16-byte streaming
//      stores (the outputs are not re-read), rank = slot - the digit's
//      first slot;
//   4. the values then pass through the same staging buffer: one vector
//      read into shared memory, gathered through the order, 16-byte stores.
// At KPB 6912 with 4-byte keys and values that is 96 KB of shared memory,
// two CTAs of 512 threads per SM.
//
// Widths 9..16: two stable 8-bit counting rounds (the digit's low byte,
// then its high bits) give the order; the digits are kept as uint16; each
// slot's run start comes from a scan of the slots where the digit changes
// (run_starts), and the sparse histogram row (one entry per run) is written
// into the zeroed output.  Widths past 16 are refused (digit_at).
//
// The reference rebuilt keys and values from ceil(bits / 16) 16-bit halves,
// so only their low 16 * ceil(key_bits / 16) (val_bits) bits survive: the
// wrapper passes those masks.  Digits use the key dtype's own shift.
#include "common.cuh"

constexpr int kSplitThreads = 512;
constexpr int kSplitWarps = kSplitThreads / 32;
// the phases a launch runs (tile_multisplit_probe times them apart); the
// tile is always loaded.  A runtime argument on purpose: as a template
// parameter, the shipped kernel free of the identity-order branch, ptxas
// scheduled the keys kernel differently, and it took 2.56-2.62 ms in place
// of 2.26-2.32 at the library phase's shape (scripts/
// torch_checkout_times.py multisplit, both forms alternating in one call
// on an H100 80GB HBM3 at 700 W).  Fences, barriers, unrolling and launch
// bounds did not bring it back; the runtime rank branch does.
constexpr int kRankPhase = 1, kWritePhase = 2;
constexpr int kAllPhases = kRankPhase | kWritePhase;

__host__ __device__ constexpr size_t split_align(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of one CTA's shared memory: the staging buffer (keys, then
// values), the slot -> element order, the rank scratch, the staged digits,
// the run starts (widths past 8), the per-warp counts and digit bitmasks,
// the bins and their starts.
struct SplitLayout {
  size_t order, tmp, sdig, rstart, wcnt, masks, bins, total;
  __host__ __device__ SplitLayout(int kpb, int key_bytes, int val_bytes,
                                  int width) {
    const size_t k = static_cast<size_t>(kpb);
    const bool wide = width > 8;
    order = split_align(k * (key_bytes > val_bytes ? key_bytes : val_bytes));
    tmp = order + split_align(2 * k);
    sdig = tmp + split_align(2 * k);
    rstart = sdig + split_align(k * (wide ? 2 : 1));
    wcnt = rstart + (wide ? split_align(2 * k) : 0);
    masks = wcnt + sizeof(int) * kSplitWarps * kRoundBins;
    bins = masks + sizeof(unsigned) * kSplitWarps * kRoundBins;
    total = bins + sizeof(int) * 2 * kRoundBins;
  }
};

template <typename K, typename V, bool KV, typename D>
__global__ void __launch_bounds__(kSplitThreads, 2)
multisplit_kernel(const K* __restrict__ keys, const V* __restrict__ vals,
                  K* __restrict__ out_keys, V* __restrict__ out_vals,
                  int* __restrict__ out_digit, int* __restrict__ out_rank,
                  int* __restrict__ out_hist, int kpb, int shift, int width,
                  int logical, K key_mask, V val_mask, int phases) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SplitLayout lay(kpb, sizeof(K), KV ? sizeof(V) : 0, width);
  K* skeys = reinterpret_cast<K*>(smem);                   // (kpb,) keys
  V* svals = reinterpret_cast<V*>(smem);                   // then values
  auto* order = reinterpret_cast<unsigned short*>(smem + lay.order);
  auto* tmp = reinterpret_cast<unsigned short*>(smem + lay.tmp);
  D* sdig = reinterpret_cast<D*>(smem + lay.sdig);
  auto* rstart = reinterpret_cast<unsigned short*>(smem + lay.rstart);
  int* wcnt = reinterpret_cast<int*>(smem + lay.wcnt);
  auto* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  int* bins = reinterpret_cast<int*>(smem + lay.bins);     // (256,)
  int* bexcl = bins + kRoundBins;                          // (256,)

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kpb;
  const bool wide = width > 8;
  if constexpr (KV)     // the values are read last: have L2 fetch them now
    if (tid == 0)
      prefetch_l2(vals, base * sizeof(V), (base + kpb) * sizeof(V));
  for (int i = tid; i < kSplitWarps * kRoundBins; i += blockDim.x)
    masks[i] = 0;
  load_row<K>(keys + base, kpb, skeys);
  __syncthreads();

  // 1. the stable digit-major order of the tile
  auto digit = [&](int i) {
    return digit_at(skeys[i], shift, width, logical != 0);
  };
  if (phases & kRankPhase) {
    stable_digit_order<kSplitWarps>(kpb, width, digit, order, tmp, sdig,
                                    wcnt, masks, bins, bexcl);
  } else {   // the probe's write-only phase: the identity order
    for (int s = tid; s < kpb; s += blockDim.x) {
      order[s] = static_cast<unsigned short>(s);
      sdig[s] = 0;
      if (wide) rstart[s] = 0;
    }
    for (int b = tid; b < kRoundBins; b += blockDim.x) bexcl[b] = 0;
    __syncthreads();
  }
  if (!(phases & kWritePhase)) return;

  // 2. the histogram row and each slot's run start
  const int r = 1 << width;
  int* hist = out_hist + static_cast<long long>(blockIdx.x) * r;
  if (!wide) {
    for (int d = tid; d < r; d += blockDim.x) hist[d] = bins[d];
  } else {
    if (phases & kRankPhase) {
      run_starts(sdig, kpb, rstart, bins);
      __syncthreads();
    }
    for (int s = tid; s < kpb; s += blockDim.x)   // one entry per run
      if (s == kpb - 1 || sdig[s + 1] != sdig[s])
        hist[sdig[s]] = s + 1 - rstart[s];
  }

  // 3. keys, digits and ranks in slot order, 16-byte streaming stores (the
  //    digit and rank outputs share their alignment: one walk, one read of
  //    each slot's digit)
  store_run<K, true>(out_keys + base, kpb, [&](int s) {
    return static_cast<K>(skeys[order[s]] & key_mask);
  });
  store_pair<true>(out_digit + base, out_rank + base, kpb, [&](int s) {
    const int d = sdig[s];
    return int2{d, s - (wide ? static_cast<int>(rstart[s]) : bexcl[d])};
  });

  // 4. the values through the same staging buffer
  if constexpr (KV) {
    __syncthreads();   // the keys' last readers are done
    load_row<V>(vals + base, kpb, svals);
    __syncthreads();
    store_run<V, true>(out_vals + base, kpb, [&](int s) {
      return static_cast<V>(svals[order[s]] & val_mask);
    });
  }
}

REPRO_ERROR_STRING

// A tile over the card's opt-in shared memory per CTA (227 KB on the H100)
// is refused with cudaErrorInvalidValue (the wrapper names the limit).
template <typename K, typename V, bool KV, typename D>
static int launch_split(const void* keys, const void* vals, void* out_keys,
                        void* out_vals, int* out_digit, int* out_rank,
                        int* out_hist, int tiles, int kpb, int shift,
                        int width, int logical, unsigned long long key_mask,
                        unsigned long long val_mask, int phases,
                        cudaStream_t s) {
  const size_t shmem =
      SplitLayout(kpb, sizeof(K), KV ? sizeof(V) : 0, width).total;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (shmem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(multisplit_kernel<K, V, KV, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  multisplit_kernel<K, V, KV, D><<<tiles, kSplitThreads, shmem, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals),
      static_cast<K*>(out_keys), static_cast<V*>(out_vals), out_digit,
      out_rank, out_hist, kpb, shift, width, logical,
      static_cast<K>(key_mask), static_cast<V>(val_mask), phases);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, typename V, bool KV>
static int split_by_width(const void* keys, const void* vals, void* out_keys,
                          void* out_vals, int* out_digit, int* out_rank,
                          int* out_hist, int tiles, int kpb, int shift,
                          int width, int logical, unsigned long long key_mask,
                          unsigned long long val_mask, int phases,
                          cudaStream_t s) {
  // one staged digit byte up to width 8; 16-bit digits (and two rounds)
  // past it
  return width > 8
      ? launch_split<K, V, KV, uint16_t>(
            keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
            tiles, kpb, shift, width, logical, key_mask, val_mask, phases, s)
      : launch_split<K, V, KV, uint8_t>(
            keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
            tiles, kpb, shift, width, logical, key_mask, val_mask, phases, s);
}

template <typename K>
static int split_by_value(int val_bytes, const void* keys, const void* vals,
                          void* out_keys, void* out_vals, int* out_digit,
                          int* out_rank, int* out_hist, int tiles, int kpb,
                          int shift, int width, int logical,
                          unsigned long long key_mask,
                          unsigned long long val_mask, int phases,
                          cudaStream_t s) {
  switch (val_bytes) {
    case 0: return split_by_width<K, uint8_t, false>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, phases,
                s);
    case 2: return split_by_width<K, uint16_t, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, phases,
                s);
    case 4: return split_by_width<K, uint32_t, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, phases,
                s);
    case 8: return split_by_width<K, unsigned long long, true>(
                keys, vals, out_keys, out_vals, out_digit, out_rank, out_hist,
                tiles, kpb, shift, width, logical, key_mask, val_mask, phases,
                s);
    default: return cudaErrorInvalidValue;
  }
}

static int split_launch(const void* keys, const void* vals, void* out_keys,
                        void* out_vals, void* out_digit, void* out_rank,
                        void* out_hist, int key_bytes, int val_bytes,
                        int tiles, int kpb, int shift, int width, int logical,
                        unsigned long long key_mask,
                        unsigned long long val_mask, int phases,
                        void* stream) {
  if (width < 1 || width > 16 || tiles < 1 || kpb < 1 || kpb > 65536 ||
      key_bytes == 1 || phases < 0 || phases > kAllPhases)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* dg = static_cast<int*>(out_digit);
  int* rk = static_cast<int*>(out_rank);
  int* hs = static_cast<int*>(out_hist);
  REPRO_DISPATCH_KEY(key_bytes, K,
    return split_by_value<K>(val_bytes, keys, vals, out_keys, out_vals, dg,
                             rk, hs, tiles, kpb, shift, width, logical,
                             key_mask, val_mask, phases, s))
  return cudaErrorInvalidValue;
}

// (tiles, kpb) keys [and values] -> digit-major keys [values], digits,
// ranks (tiles, kpb) and histograms (tiles, 2^width), the histograms
// zeroed by the caller.  val_bytes 0: keys only (vals, out_vals null).
// Keys of 2, 4 or 8 bytes; widths 1..16; kpb <= 65536.
extern "C" int tile_multisplit_launch(
    const void* keys, const void* vals, void* out_keys, void* out_vals,
    void* out_digit, void* out_rank, void* out_hist, int key_bytes,
    int val_bytes, int tiles, int kpb, int shift, int width, int logical,
    unsigned long long key_mask, unsigned long long val_mask, void* stream) {
  return split_launch(keys, vals, out_keys, out_vals, out_digit, out_rank,
                      out_hist, key_bytes, val_bytes, tiles, kpb, shift,
                      width, logical, key_mask, val_mask, kAllPhases, stream);
}

// The same launch with only some phases (the load always): 0 load only,
// kRankPhase load and rank, kWritePhase load and the writes of an identity
// order.  For timing only (scripts/torch_multisplit_breakdown.py): the
// outputs of a partial launch are not the multisplit's.
extern "C" int tile_multisplit_probe(
    const void* keys, const void* vals, void* out_keys, void* out_vals,
    void* out_digit, void* out_rank, void* out_hist, int key_bytes,
    int val_bytes, int tiles, int kpb, int shift, int width, int logical,
    unsigned long long key_mask, unsigned long long val_mask, int phases,
    void* stream) {
  return split_launch(keys, vals, out_keys, out_vals, out_digit, out_rank,
                      out_hist, key_bytes, val_bytes, tiles, kpb, shift,
                      width, logical, key_mask, val_mask, phases, stream);
}
