// Row sorts of the library surface: the port of
// repro/kernels/bitonic.py::_bitonic_kernel (keys) and ::_bitonic_kv_kernel
// (keys with values), both the min/max network _bitonic_stages.
//
// The TPU kernels sorted a batch of (S, L) rows held in VMEM with lane-wide
// compare-exchange stages.  Here a CTA stages its rows (one row of L >=
// 2048 keys, else 2048 / L whole rows) in shared memory and runs the same
// network: size ascending, stride descending, lane i paired with i ^ stride.
// A thread takes a pair (i, i + stride) and writes both lanes' new keys
// from the old ones, as the reference's vector step does: the lower lane
// keeps min(k_i, k_p) in an ascending block and max in a descending one,
// the upper lane the other.  KV: a lane takes its partner's value iff its
// key compares != after the step (the reference's move mask; not stable).
//
// The min and max are XLA's, written as explicit selects on the bits, so
// the output is byte-identical to the reference's:
//   * integers: the dtype's order (unsigned keys compare unsigned);
//   * floats: NaN propagates.  With one NaN operand the result is that
//     NaN; with two, min keeps the lane's own operand unless its sign is
//     set and max unless it is clear.  min(+0, -0) = -0, max = +0;
//   * before the network, f32 / f64 / bf16 subnormals become zeros of
//     their sign and bf16 NaNs the quiet NaN of their sign, as XLA on the
//     CPU leaves them after their first min/max (f16 keeps both).
// fminf / fmaxf would do neither.  The KV move mask compares as floats do:
// NaN != anything, -0 == +0.
//
// Bound: bytes, 2·S·L·(kb + vb): one read and one write of every key and
// value.  The network does S·L/2·log2(L)·(log2(L)+1)/2 compare-exchanges
// in shared memory (91 stages of 4096 pairs per row at L = 8192), which is
// what this simple kernel pays for.  L·(kb + vb) must fit the 227 KB of
// opt-in shared memory.
#include "common.cuh"

constexpr int kCtaElems = 2048;   // keys a CTA stages when rows are short
constexpr int kRowThreads = 512;

enum RowKind { kUint = 0, kSint = 1, kF16 = 2, kBf16 = 3, kF32 = 4, kF64 = 5 };

template <typename K, int KIND>
struct RowKey {
  static constexpr bool kFloat = KIND >= kF16;
  static constexpr K kSign = static_cast<K>(K(1) << (sizeof(K) * 8 - 1));
  static constexpr K kMag = static_cast<K>(~kSign);
  // +inf's bits (every exponent bit) and the mantissa width
  static constexpr K kExp = static_cast<K>(
      KIND == kF16 ? 0x7C00ull : KIND == kBf16 ? 0x7F80ull
      : KIND == kF32 ? 0x7F800000ull : 0x7FF0000000000000ull);
  static constexpr int kMant = KIND == kF16 ? 10 : KIND == kBf16 ? 7
                               : KIND == kF32 ? 23 : 52;

  // unsigned key of the dtype's order (floats: totalOrder, -0 below +0)
  __device__ static K order(K x) {
    if (KIND == kUint) return x;
    if (KIND == kSint) return static_cast<K>(x ^ kSign);
    return (x & kSign) ? static_cast<K>(~x) : static_cast<K>(x | kSign);
  }
  __device__ static bool nan(K x) {
    return kFloat && static_cast<K>(x & kMag) > kExp;
  }
  __device__ static K prepare(K x) {
    if (!kFloat || KIND == kF16) return x;
    const K mag = static_cast<K>(x & kMag);
    if (mag != 0 && mag < static_cast<K>(K(1) << kMant))
      return static_cast<K>(x & kSign);
    if (KIND == kBf16 && mag > kExp)
      return static_cast<K>((x & kSign) | 0x7FC0);
    return x;
  }
  // the lane's new key: min(x, y) if take_min else max(x, y), x its own
  __device__ static K pick(K x, K y, bool take_min) {
    const K ox = order(x), oy = order(y);
    bool keep_x = take_min ? ox <= oy : ox >= oy;
    if (kFloat) {
      const bool xn = nan(x), yn = nan(y);
      if (xn || yn) {
        const bool xneg = (x & kSign) != 0;
        keep_x = xn && (!yn || (take_min ? !xneg : xneg));
      }
    }
    return keep_x ? x : y;
  }
  // the value rule: did the lane's key change, comparing as the dtype does
  __device__ static bool moved(K now, K was) {
    if (!kFloat) return now != was;
    return nan(now) || nan(was) ||
           (now != was && static_cast<K>((now | was) & kMag) != 0);
  }
};

__host__ __device__ inline size_t align8(size_t bytes) {
  return (bytes + 7) / 8 * 8;
}

template <typename K, int KIND, typename V, bool KV>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const K* __restrict__ in_keys, const V* __restrict__ in_vals,
            K* __restrict__ out_keys, V* __restrict__ out_vals, int rows,
            int len, int rows_per_cta) {
  using Key = RowKey<K, KIND>;
  extern __shared__ unsigned long long smem_raw[];
  K* sk = reinterpret_cast<K*>(smem_raw);
  V* sv = reinterpret_cast<V*>(reinterpret_cast<unsigned char*>(smem_raw) +
                               align8(sizeof(K) * rows_per_cta * len));
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int n = static_cast<int>(min(static_cast<long long>(rows_per_cta),
                                     rows - row0)) * len;
  const long long base = row0 * len;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sk[j] = Key::prepare(in_keys[base + j]);
    if (KV) sv[j] = in_vals[base + j];
  }
  __syncthreads();
  const int half = n >> 1;
  for (int size = 2; size <= len; size <<= 1) {
    // a pair's block is ascending unless its bit `size` is set; the whole
    // row (size == len) is ascending
    const int dir_bit = size & (len - 1);
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int sl = __ffs(stride) - 1;
      for (int c = threadIdx.x; c < half; c += blockDim.x) {
        const int i = ((c >> sl) << (sl + 1)) | (c & (stride - 1));
        const int p = i + stride;
        const bool asc = (i & dir_bit) == 0;
        const K ki = sk[i], kp = sk[p];
        const K ni = Key::pick(ki, kp, asc);
        const K np = Key::pick(kp, ki, !asc);
        sk[i] = ni;
        sk[p] = np;
        if (KV) {
          const V vi = sv[i], vp = sv[p];
          if (Key::moved(ni, ki)) sv[i] = vp;
          if (Key::moved(np, kp)) sv[p] = vi;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    out_keys[base + j] = sk[j];
    if (KV) out_vals[base + j] = sv[j];
  }
}

REPRO_ERROR_STRING

constexpr size_t kSmemLimit = 232448;

template <typename K, int KIND, typename V, bool KV>
static int launch_rows(const void* keys, const void* vals, void* out_keys,
                       void* out_vals, int rows, int len, cudaStream_t s) {
  const int rpc = len >= kCtaElems ? 1 : kCtaElems / len;
  const size_t shmem = align8(sizeof(K) * rpc * len) +
                       (KV ? sizeof(V) * rpc * len : 0);
  if (shmem > kSmemLimit) return cudaErrorInvalidValue;
  const int threads = min(kRowThreads, max(32, rpc * len / 2));
  const cudaError_t e = cudaFuncSetAttribute(
      rows_kernel<K, KIND, V, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rows_kernel<K, KIND, V, KV><<<(rows + rpc - 1) / rpc, threads, shmem, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals),
      static_cast<K*>(out_keys), static_cast<V*>(out_vals), rows, len, rpc);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, int KIND>
static int by_value(int val_bytes, const void* keys, const void* vals,
                    void* out_keys, void* out_vals, int rows, int len,
                    cudaStream_t s) {
  switch (val_bytes) {
    case 0: return launch_rows<K, KIND, uint8_t, false>(
                keys, vals, out_keys, out_vals, rows, len, s);
    case 1: return launch_rows<K, KIND, uint8_t, true>(
                keys, vals, out_keys, out_vals, rows, len, s);
    case 2: return launch_rows<K, KIND, uint16_t, true>(
                keys, vals, out_keys, out_vals, rows, len, s);
    case 4: return launch_rows<K, KIND, uint32_t, true>(
                keys, vals, out_keys, out_vals, rows, len, s);
    case 8: return launch_rows<K, KIND, unsigned long long, true>(
                keys, vals, out_keys, out_vals, rows, len, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
static int by_key(int key_bytes, int val_bytes, const void* keys,
                  const void* vals, void* out_keys, void* out_vals, int rows,
                  int len, cudaStream_t s) {
  REPRO_DISPATCH_KEY(key_bytes, K,
    return by_value<K, KIND>(val_bytes, keys, vals, out_keys, out_vals, rows,
                             len, s))
  return cudaErrorInvalidValue;
}

// (rows, len) keys -> rows sorted by the network; kind is a RowKind, vals
// and out_vals null when val_bytes is 0.  len a power of two >= 2.
extern "C" int bitonic_rows_launch(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals, int kind,
                                   int key_bytes, int val_bytes, int rows,
                                   int len, void* stream) {
  if (len < 2 || (len & (len - 1)) || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kUint: return by_key<kUint>(key_bytes, val_bytes, keys, vals,
                                     out_keys, out_vals, rows, len, s);
    case kSint: return by_key<kSint>(key_bytes, val_bytes, keys, vals,
                                     out_keys, out_vals, rows, len, s);
    case kF16:
      if (key_bytes != 2) return cudaErrorInvalidValue;
      return by_value<uint16_t, kF16>(val_bytes, keys, vals, out_keys,
                                      out_vals, rows, len, s);
    case kBf16:
      if (key_bytes != 2) return cudaErrorInvalidValue;
      return by_value<uint16_t, kBf16>(val_bytes, keys, vals, out_keys,
                                       out_vals, rows, len, s);
    case kF32:
      if (key_bytes != 4) return cudaErrorInvalidValue;
      return by_value<uint32_t, kF32>(val_bytes, keys, vals, out_keys,
                                      out_vals, rows, len, s);
    case kF64:
      if (key_bytes != 8) return cudaErrorInvalidValue;
      return by_value<unsigned long long, kF64>(val_bytes, keys, vals,
                                                out_keys, out_vals, rows,
                                                len, s);
    default: return cudaErrorInvalidValue;
  }
}
