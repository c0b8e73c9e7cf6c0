// Row sorts of the library surface: the port of
// repro/kernels/bitonic.py::_bitonic_kernel (keys) and ::_bitonic_kv_kernel
// (keys with values), both the min/max network _bitonic_stages, redesigned
// for the H100.
//
// The TPU kernels sorted a batch of (S, L) rows held in VMEM with lane-wide
// compare-exchange stages: size ascending, stride descending, lane i paired
// with i ^ stride; the lower lane keeps min(k_i, k_p) in an ascending block
// and max in a descending one, the upper lane the other.  KV: a lane takes
// its partner's value iff its key compares != after the step (the
// reference's move mask; not stable).  This kernel runs exactly those
// stages, pair for pair; only which thread owns which lanes changes.
//
// A CTA stages its tile in shared memory: one row of L >= kCtaElems keys,
// else kCtaElems / L whole rows.  The stages then run in phases.  In a phase
// each thread reads 2^LOGE lanes (16; 32 for 4-byte integer keys with
// values of at most 4 bytes) whose indices differ only in the bits
// [w, w + LOGE) (the phase's window) into registers, runs every stage whose
// stride bit lies in the window there, and writes them back; a barrier
// separates phases.  The first phase (w = 0) runs merges 2..2^LOGE whole;
// every wider merge of size 2^m runs its strides m-1, m-2, ... in windows
// of LOGE bits from the top down to w = 0.  At L = 8192 and 16 lanes that
// is 25 phases of two shared accesses per lane in place of 91 stages of
// two loads and two stores per pair with a barrier each.  Shared indices are padded by one
// word in 32 (i + i / 32), so a warp's 32 lanes of one register fall in
// distinct banks for w = 0 and w >= 5 (two-way at most otherwise).  A
// tile wider than 512 threads' lanes gives each thread several lane groups
// in turn.
//
// The min and max are XLA's, written as explicit selects on the bits, so
// the output is byte-identical to the reference's:
//   * integers: the dtype's order (unsigned keys compare unsigned); the
//     4-bit kinds by their low nibble, which is all they keep;
//   * floats: NaN propagates.  With one NaN operand the result is that
//     NaN; with two, min keeps the lane's own operand unless its sign is
//     set and max unless it is clear.  min(+0, -0) = -0, max = +0;
//   * before the network, f32 / f64 / bf16 subnormals become zeros of
//     their sign, bf16 NaNs the quiet NaN of their sign and float8_e5m2
//     NaNs +NaN (0x7F), as XLA on the CPU leaves them after their first
//     min/max (f16 and the other float8 formats keep both);
//   * float8_e4m3fn's NaNs are 0x7F / 0xFF (no inf); the fnuz formats' one
//     NaN is 0x80 (no -0); float8_e8m0fnu has no sign, 0xFF is its NaN,
//     and a min or max that returns its smallest value 0x00 (2^-127, which
//     XLA flushes to zero) returns 0xFF, the NaN that zero converts to.
// fminf / fmaxf would do none of this.  The KV move mask compares as
// floats do: NaN != anything, -0 == +0.  A phase's lane group with no NaN
// (and, for e8m0fnu, no 0x00) runs in the totalOrder key space, where those
// min/max are plain unsigned ones and a swap of -0 and +0 moves no value;
// a group with one runs the bit-level picks on its lanes in shared memory,
// in a loop that is not unrolled (the unrolled picks of every float kind
// and width made the file's build minutes long; a register version with
// only the pair loop unrolled measured no faster on rows with NaNs and
// slowed the finite ones: PERF.md).  Every integer kind runs
// one unsigned kernel per key width (signed keys with their sign bit
// flipped, 4-bit keys as their low nibble), and the four sign-magnitude
// float8 formats one kernel whose NaN rule is a launch argument.
//
// Bound: operations, not bytes.  The bytes are 2·S·L·(kb + vb), one read
// and one write of every key and value (0.64 ms for 2^28 uint32 keys at
// 3.35 TB/s).  The network is S·L/2·log2(L)·(log2(L)+1)/2 compare-
// exchanges (12.2 G at 2^28 keys, L = 8192), each at least 2 integer
// instructions for keys alone (a min and a max) and 5 with values (a
// compare and four selects), at 64 INT32 lanes per SM per clock.  L·(kb +
// vb) plus the padding must fit the 227 KB of opt-in shared memory.
#include "common.cuh"

constexpr int kCtaElems = 2048;   // lanes a CTA stages when rows are short
constexpr int kLogE = 4;          // lanes per thread: 2^kLogE ...
constexpr int kLogE32 = 5;        // ... 2^kLogE32 for 4-byte integer keys
constexpr int kRowThreads = 512;  // threads per CTA at most

// The wrapper's compare kinds (ref.row_kind).
enum RowKind {
  kUint = 0, kSint = 1, kF16 = 2, kBf16 = 3, kF32 = 4, kF64 = 5,
  kE4M3FN = 6, kE5M2 = 7, kE4M3FNUZ = 8, kE5M2FNUZ = 9, kE8M0 = 10,
  kI4 = 11, kU4 = 12,
  // the kernel's: every integer kind runs as kUint (Fmt's mask and flip),
  // the four sign-magnitude float8 formats as kF8 (Fmt's NaN rule)
  kF8 = 13
};

// What a kernel kind leaves to run time.  Integers are staged as
// (x & mask) ^ flip and sorted unsigned, then written back ^ flip (a signed
// key flips its sign bit; a 4-bit key keeps its low nibble, int4 flipping
// bit 3).  A kF8 key's NaNs: f8 names the rule.
enum F8Rule { kNanAbove7E = 0, kNanAbove7C = 1, kNan80 = 2 };
struct Fmt {
  unsigned long long mask, flip;
  int f8;
};

template <typename K, int KIND>
struct RowKey {
  static constexpr bool kFloat = KIND != kUint;
  static constexpr K kSign = static_cast<K>(K(1) << (sizeof(K) * 8 - 1));
  static constexpr K kMag = static_cast<K>(~kSign);
  // the largest magnitude that is not a NaN, and the mantissa width
  static constexpr K kExp = static_cast<K>(
      KIND == kF16 ? 0x7C00ull : KIND == kBf16 ? 0x7F80ull
      : KIND == kF32 ? 0x7F800000ull : 0x7FF0000000000000ull);
  static constexpr int kMant = KIND == kF16 ? 10 : KIND == kBf16 ? 7
                               : KIND == kF32 ? 23 : 52;

  // unsigned key of the dtype's order (floats: totalOrder, -0 below +0)
  __device__ static K order(K x) {
    if (KIND == kUint || KIND == kE8M0) return x;
    return (x & kSign) ? static_cast<K>(~x) : static_cast<K>(x | kSign);
  }
  // inverse of order()
  __device__ static K from_order(K o) {
    if (KIND == kUint || KIND == kE8M0) return o;
    return (o & kSign) ? static_cast<K>(o ^ kSign) : static_cast<K>(~o);
  }
  __device__ static bool nan(K x, int f8) {
    if (!kFloat) return false;
    if (KIND == kE8M0) return x == K(0xFF);
    if (KIND == kF8)
      return f8 == kNan80 ? x == kSign
                          : (x & kMag) > (f8 == kNanAbove7C ? 0x7C : 0x7E);
    return static_cast<K>(x & kMag) > kExp;
  }
  // the staged key
  __device__ static K prepare(K x, const Fmt& fmt) {
    if constexpr (KIND == kUint) {
      return static_cast<K>((x & static_cast<K>(fmt.mask)) ^
                            static_cast<K>(fmt.flip));
    } else if constexpr (KIND == kF8) {
      return fmt.f8 == kNanAbove7C && nan(x, fmt.f8) ? K(0x7F) : x;
    } else if constexpr (KIND == kF32 || KIND == kF64 || KIND == kBf16) {
      const K mag = static_cast<K>(x & kMag);
      if (mag != 0 && mag < static_cast<K>(K(1) << kMant))
        return static_cast<K>(x & kSign);
      if (KIND == kBf16 && mag > kExp)
        return static_cast<K>((x & kSign) | 0x7FC0);
      return x;
    } else {
      return x;
    }
  }
  // the lane's new key: min(x, y) if take_min else max(x, y), x its own
  __device__ static K pick(K x, K y, bool take_min, int f8) {
    const K ox = order(x), oy = order(y);
    bool keep_x = take_min ? ox <= oy : ox >= oy;
    if (kFloat) {
      const bool xn = nan(x, f8), yn = nan(y, f8);
      if (xn || yn) {
        const bool xneg = (x & kSign) != 0;
        keep_x = xn && (!yn || (take_min ? !xneg : xneg));
      }
    }
    const K r = keep_x ? x : y;
    return KIND == kE8M0 && r == 0 ? K(0xFF) : r;
  }
  // a key the min/max do not treat by its order: a NaN, or e8m0fnu's
  // 0x00 (a min or max returning it returns the NaN)
  __device__ static bool special(K x, int f8) {
    return nan(x, f8) || (KIND == kE8M0 && x == 0);
  }
  // formats with a -0: a swap of -0 and +0 moves no value (kF8 counts the
  // fnuz formats, whose 0x80 is their NaN: never in the order space)
  static constexpr bool kSignedZero = kFloat && KIND != kE8M0;
  // order(x) of a zero of either sign
  __device__ static bool order_zero(K o) { return o == kSign || o == kMag; }
  // the value rule: did the lane's key change, comparing as the dtype does
  __device__ static bool moved(K now, K was, int f8) {
    if (!kFloat) return now != was;
    if (KIND == kE8M0) return nan(now, f8) || nan(was, f8) || now != was;
    return nan(now, f8) || nan(was, f8) ||
           (now != was && static_cast<K>((now | was) & kMag) != 0);
  }
};

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// a lane's padded shared-memory index
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One compare-exchange of the lower lane a and the upper lane b of a pair
// in a descending (DESC) or ascending block, a and b order() keys with no
// special key among them (every integer kind; a float lane group with no
// NaN, and no 0x00 for e8m0fnu).  XLA's min and max are then the order's:
// keys alone take the min and the max; with values a swap, which moves the
// values unless both keys are zeros (-0 == +0: the keys reorder, the
// values stay).
template <typename K, int KIND, typename V, bool KV, bool DESC>
__device__ __forceinline__ void exchange(K& a, K& b, V& va, V& vb) {
  using Key = RowKey<K, KIND>;
  if constexpr (!KV) {
    const K lo = min(a, b), hi = max(a, b);
    a = DESC ? hi : lo;
    b = DESC ? lo : hi;
  } else {
    const bool swap = DESC ? a < b : b < a;
    bool vswap = swap;
    if constexpr (Key::kSignedZero)
      vswap = swap && !(Key::order_zero(a) && Key::order_zero(b));
    const K na = swap ? b : a;
    b = swap ? a : b;
    a = na;
    const V nva = vswap ? vb : va;
    vb = vswap ? va : vb;
    va = nva;
  }
}

// The same compare-exchange on the float bits of shared lanes ia (lower)
// and ib, for a lane group with a special key: each lane picks as the
// reference does (with two NaNs both may keep one), values by the move
// mask.  Not unrolled: only groups that hold a NaN run it.
template <typename K, int KIND, typename V, bool KV>
__device__ __forceinline__ void exchange_slow(K* sk, V* sv, int ia, int ib,
                                              bool desc, int f8) {
  using Key = RowKey<K, KIND>;
  const K a = sk[ia], b = sk[ib];
  const K na = Key::pick(a, b, !desc, f8);
  const K nb = Key::pick(b, a, desc, f8);
  if constexpr (KV) {
    const V va = sv[ia], vb = sv[ib];
    sv[ia] = Key::moved(na, a, f8) ? vb : va;
    sv[ib] = Key::moved(nb, b, f8) ? va : vb;
  }
  sk[ia] = na;
  sk[ib] = nb;
}

// One stage whose stride is register bit kb of the window, every pair in
// the thread's direction: registers j and j | 2^kb pair up (KB walks
// 0 .. LOGE-1 to the runtime kb).
template <int LOGE, int KB, typename K, int KIND, typename V, bool KV,
          bool DESC>
__device__ __forceinline__ void stage(K (&k)[1 << LOGE], V (&v)[1 << LOGE],
                                      int kb) {
  if constexpr (KB < LOGE) {
    if (kb != KB) {
      stage<LOGE, KB + 1, K, KIND, V, KV, DESC>(k, v, kb);
      return;
    }
    constexpr int p = 1 << KB;
#pragma unroll
    for (int j = 0; j < (1 << LOGE); ++j)
      if (!(j & p))
        exchange<K, KIND, V, KV, DESC>(k[j], k[j | p], v[j], v[j | p]);
  }
}

// Whether none of the thread's lanes is special (always, for an integer
// kind).  Within a phase a thread's lanes meet no other lanes, so a group
// that starts clean stays clean and runs in order() space in registers;
// any other runs exchange_slow on its lanes in shared memory.
template <typename K, int KIND, int E>
__device__ __forceinline__ bool clean(const K (&k)[E], int f8) {
  using Key = RowKey<K, KIND>;
  bool ok = true;
  if constexpr (Key::kFloat) {
#pragma unroll
    for (int j = 0; j < E; ++j) ok = ok && !Key::special(k[j], f8);
  }
  return ok;
}

template <typename K, int KIND, int E, bool TO>
__device__ __forceinline__ void reorder(K (&k)[E]) {
  using Key = RowKey<K, KIND>;
#pragma unroll
  for (int j = 0; j < E; ++j)
    k[j] = TO ? Key::order(k[j]) : Key::from_order(k[j]);
}

// The thread's lanes of window [w, w + LOGE) between padded shared memory
// and registers.  For w = 0 and w >= 5 the padded index is linear in the
// register (no carry crosses bit 5), so it is one add each.
template <int LOGE, typename K, typename V, bool KV, bool STORE>
__device__ __forceinline__ void lanes(K* sk, V* sv, K (&k)[1 << LOGE],
                                      V (&v)[1 << LOGE], int base, int w) {
  constexpr int E = 1 << LOGE;
  if (w == 0 || w >= 5) {
    const int p0 = pad(base), step = (1 << w) + ((1 << w) >> 5);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = p0 + j * step;
      if (STORE) {
        sk[i] = k[j];
        if (KV) sv[i] = v[j];
      } else {
        k[j] = sk[i];
        if (KV) v[j] = sv[i];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = pad(base + (j << w));
      if (STORE) {
        sk[i] = k[j];
        if (KV) sv[i] = v[j];
      } else {
        k[j] = sk[i];
        if (KV) v[j] = sv[i];
      }
    }
  }
}

// The direction of register j's pair in merge m of the first phase: merge
// lg, the row's last, sorts up; a merge below LOGE by register bit m, merge
// LOGE by the thread's own bit (tdesc).
template <int LOGE>
__device__ __forceinline__ bool first_desc(int j, int m, int lg,
                                           bool tdesc) {
  return m != lg && (m < LOGE ? ((j >> m) & 1) != 0 : tdesc);
}

// The first phase's stages on one lane group: merges 1 .. min(lg, LOGE)
// whole.  A thread's lanes are 2^LOGE consecutive ones, so every pair's
// direction is known at compile time once unrolled, or per thread.
template <int LOGE, typename K, int KIND, typename V, bool KV>
__device__ __forceinline__ void first_stages(K (&k)[1 << LOGE],
                                             V (&v)[1 << LOGE], int lg,
                                             bool tdesc) {
#pragma unroll
  for (int m = 1; m <= LOGE; ++m) {
    if (m > lg) break;
#pragma unroll
    for (int b = m - 1; b >= 0; --b) {
#pragma unroll
      for (int j = 0; j < (1 << LOGE); ++j) {
        const int p = 1 << b;
        if (j & p) continue;
        if (first_desc<LOGE>(j, m, lg, tdesc))
          exchange<K, KIND, V, KV, true>(k[j], k[j | p], v[j], v[j | p]);
        else
          exchange<K, KIND, V, KV, false>(k[j], k[j | p], v[j], v[j | p]);
      }
    }
  }
}

// The first phase, window [0, LOGE).
template <int LOGE, typename K, int KIND, typename V, bool KV>
__device__ void first_phase(K* sk, V* sv, int tile, int lg, int f8) {
  constexpr int E = 1 << LOGE;
  for (int vt = threadIdx.x; vt < (tile >> LOGE); vt += blockDim.x) {
    const int base = vt << LOGE;
    K k[E];
    V v[E];
    lanes<LOGE, K, V, KV, false>(sk, sv, k, v, base, 0);
    const bool tdesc = (base >> LOGE) & 1;    // bit LOGE: merge LOGE's
    if (clean<K, KIND, E>(k, f8)) {
      reorder<K, KIND, E, true>(k);
      first_stages<LOGE, K, KIND, V, KV>(k, v, lg, tdesc);
      reorder<K, KIND, E, false>(k);
      lanes<LOGE, K, V, KV, true>(sk, sv, k, v, base, 0);
    } else if constexpr (RowKey<K, KIND>::kFloat) {
#pragma unroll 1
      for (int m = 1; m <= min(lg, LOGE); ++m)
#pragma unroll 1
        for (int b = m - 1; b >= 0; --b)
#pragma unroll 1
          for (int j = 0; j < E; ++j)
            if (!((j >> b) & 1))
              exchange_slow<K, KIND, V, KV>(
                  sk, sv, pad(base + j), pad(base + (j | 1 << b)),
                  first_desc<LOGE>(j, m, lg, tdesc), f8);
    }
  }
  __syncthreads();
}

// A later phase's stages on one lane group: strides btop down to w, every
// pair in the thread's direction.
template <int LOGE, typename K, int KIND, typename V, bool KV>
__device__ __forceinline__ void phase_stages(K (&k)[1 << LOGE],
                                             V (&v)[1 << LOGE], int w,
                                             int btop, bool desc) {
  if (desc) {
    for (int b = btop; b >= w; --b)
      stage<LOGE, 0, K, KIND, V, KV, true>(k, v, b - w);
  } else {
    for (int b = btop; b >= w; --b)
      stage<LOGE, 0, K, KIND, V, KV, false>(k, v, b - w);
  }
}

// A later phase: window [w, w + LOGE) of merge m (m > LOGE), strides btop
// down to w.  The merge's direction bit lies above the window, so every
// pair of a thread sorts one way.
template <int LOGE, typename K, int KIND, typename V, bool KV>
__device__ void phase(K* sk, V* sv, int tile, int lg, int w, int m,
                      int btop, int f8) {
  constexpr int E = 1 << LOGE;
  const int lowmask = (1 << w) - 1;
  const int dir_bit = m == lg ? 0 : 1 << m;   // the row's last merge: up
  for (int vt = threadIdx.x; vt < (tile >> LOGE); vt += blockDim.x) {
    const int base = ((vt >> w) << (w + LOGE)) | (vt & lowmask);
    K k[E];
    V v[E];
    lanes<LOGE, K, V, KV, false>(sk, sv, k, v, base, w);
    const bool desc = (base & dir_bit) != 0;
    if (clean<K, KIND, E>(k, f8)) {
      reorder<K, KIND, E, true>(k);
      phase_stages<LOGE, K, KIND, V, KV>(k, v, w, btop, desc);
      reorder<K, KIND, E, false>(k);
      lanes<LOGE, K, V, KV, true>(sk, sv, k, v, base, w);
    } else if constexpr (RowKey<K, KIND>::kFloat) {
#pragma unroll 1
      for (int b = btop; b >= w; --b)
#pragma unroll 1
        for (int j = 0; j < E; ++j)
          if (!((j >> (b - w)) & 1))
            exchange_slow<K, KIND, V, KV>(
                sk, sv, pad(base + (j << w)),
                pad(base + ((j | 1 << (b - w)) << w)), desc, f8);
    }
  }
  __syncthreads();
}

// count elements src[0, count) to padded shared memory (or back), 16 bytes
// per global access where both ends are 16-byte aligned.
template <typename T, typename F>
__device__ void tile_in(const T* __restrict__ src, int count, T* s, F f) {
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && count % V == 0) {
    const uint4* vsrc = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < count / V; i += blockDim.x) {
      KeyVec<T> a;
      a.v = __ldcs(vsrc + i);
#pragma unroll
      for (int e = 0; e < V; ++e) s[pad(i * V + e)] = f(a.k[e]);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      s[pad(i)] = f(src[i]);
  }
}

template <typename T, typename F>
__device__ void tile_out(T* __restrict__ dst, int count, const T* s, F f) {
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && count % V == 0) {
    uint4* vdst = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < count / V; i += blockDim.x) {
      KeyVec<T> a;
#pragma unroll
      for (int e = 0; e < V; ++e) a.k[e] = f(s[pad(i * V + e)]);
      __stcs(vdst + i, a.v);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      dst[i] = f(s[pad(i)]);
  }
}

template <typename K, int KIND, typename V, bool KV, int LOGE>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const K* __restrict__ in_keys, const V* __restrict__ in_vals,
            K* __restrict__ out_keys, V* __restrict__ out_vals, int rows,
            int len, int rows_per_cta, Fmt fmt) {
  using Key = RowKey<K, KIND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = rows_per_cta * len;               // a power of two
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + align16(sizeof(K) * pad(tile)));
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  // lanes past n belong to rows past the last: staged as garbage, sorted
  // among themselves, never stored
  const int n = static_cast<int>(min(static_cast<long long>(rows_per_cta),
                                     rows - row0)) * len;
  const long long base = row0 * len;
  tile_in(in_keys + base, n, sk,
          [&](K x) { return Key::prepare(x, fmt); });
  if (KV) tile_in(in_vals + base, n, sv, [](V x) { return x; });
  __syncthreads();
  const int lg = __ffs(len) - 1;
  first_phase<LOGE, K, KIND, V, KV>(sk, sv, tile, lg, fmt.f8);
  for (int m = LOGE + 1; m <= lg; ++m) {
    for (int top = m - 1; top >= 0;) {
      const int w = top < LOGE ? 0 : top - LOGE + 1;
      phase<LOGE, K, KIND, V, KV>(sk, sv, tile, lg, w, m, top, fmt.f8);
      top = w - 1;
    }
  }
  const K flip = static_cast<K>(fmt.flip);
  tile_out(out_keys + base, n, sk,
           [flip](K x) { return static_cast<K>(x ^ flip); });
  if (KV) tile_out(out_vals + base, n, sv, [](V x) { return x; });
}

REPRO_ERROR_STRING

constexpr size_t kSmemLimit = 232448;

// Shared memory of one CTA (the wrapper's check): keys, then values, each
// padded by one lane in 32 and 16-byte aligned.
extern "C" long long bitonic_rows_smem(int len, int key_bytes,
                                       int val_bytes) {
  const long long rpc = len >= kCtaElems ? 1 : kCtaElems / len;
  const long long lanes = rpc * len + rpc * len / 32;
  return (lanes * key_bytes + 15) / 16 * 16 + lanes * val_bytes;
}

// 32 lanes a thread for 4-byte integer keys alone or with values of up to
// 4 bytes (measured faster than 16 at L = 8192 and 16384: PERF.md), 16
// otherwise (wider keys and values spill at 32).
template <typename K, int KIND, typename V, bool KV>
static int launch_rows(const void* keys, const void* vals, void* out_keys,
                       void* out_vals, int rows, int len, const Fmt& fmt,
                       cudaStream_t s) {
  constexpr int LOGE = KIND == kUint && sizeof(K) == 4 && sizeof(V) <= 4
                           ? kLogE32 : kLogE;
  const int rpc = len >= kCtaElems ? 1 : kCtaElems / len;
  const size_t shmem = bitonic_rows_smem(len, sizeof(K), KV ? sizeof(V) : 0);
  if (shmem > kSmemLimit) return cudaErrorInvalidValue;
  const int threads = min(kRowThreads, (rpc * len) >> LOGE);
  auto kernel = rows_kernel<K, KIND, V, KV, LOGE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(rows + rpc - 1) / rpc, threads, shmem, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals),
      static_cast<K*>(out_keys), static_cast<V*>(out_vals), rows, len, rpc,
      fmt);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, int KIND>
static int by_value(int val_bytes, const void* keys, const void* vals,
                    void* out_keys, void* out_vals, int rows, int len,
                    const Fmt& fmt, cudaStream_t s) {
  switch (val_bytes) {
    case 0: return launch_rows<K, KIND, uint8_t, false>(
                keys, vals, out_keys, out_vals, rows, len, fmt, s);
    case 1: return launch_rows<K, KIND, uint8_t, true>(
                keys, vals, out_keys, out_vals, rows, len, fmt, s);
    case 2: return launch_rows<K, KIND, uint16_t, true>(
                keys, vals, out_keys, out_vals, rows, len, fmt, s);
    case 4: return launch_rows<K, KIND, uint32_t, true>(
                keys, vals, out_keys, out_vals, rows, len, fmt, s);
    case 8: return launch_rows<K, KIND, unsigned long long, true>(
                keys, vals, out_keys, out_vals, rows, len, fmt, s);
    default: return cudaErrorInvalidValue;
  }
}

// (rows, len) keys -> rows sorted by the network; kind is a RowKind, vals
// and out_vals null when val_bytes is 0.  len a power of two >= 2.
extern "C" int bitonic_rows_launch(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals, int kind,
                                   int key_bytes, int val_bytes, int rows,
                                   int len, void* stream) {
  if (len < 2 || (len & (len - 1)) || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool nibble = kind == kI4 || kind == kU4;
  const int need = kind == kF16 || kind == kBf16 ? 2 : kind == kF32 ? 4
                   : kind == kF64 ? 8 : kind >= kE4M3FN && kind <= kU4 ? 1
                   : 0;                                // 0: any width
  if (kind < kUint || kind > kU4 || (need && key_bytes != need))
    return cudaErrorInvalidValue;
  Fmt fmt{~0ull, 0ull, kNanAbove7E};
  if (kind == kSint) fmt.flip = 1ull << (8 * key_bytes - 1);
  if (nibble) fmt.mask = 0xF;
  if (kind == kI4) fmt.flip = 0x8;
  if (kind == kE5M2) fmt.f8 = kNanAbove7C;
  if (kind == kE4M3FNUZ || kind == kE5M2FNUZ) fmt.f8 = kNan80;
#define REPRO_ROWS(KIND, K)                                                   \
  return by_value<K, KIND>(val_bytes, keys, vals, out_keys, out_vals, rows,   \
                           len, fmt, s)
  switch (kind) {
    case kF16: REPRO_ROWS(kF16, uint16_t);
    case kBf16: REPRO_ROWS(kBf16, uint16_t);
    case kF32: REPRO_ROWS(kF32, uint32_t);
    case kF64: REPRO_ROWS(kF64, unsigned long long);
    case kE8M0: REPRO_ROWS(kE8M0, uint8_t);
    case kE4M3FN: case kE5M2: case kE4M3FNUZ: case kE5M2FNUZ:
      REPRO_ROWS(kF8, uint8_t);
    default:                                   // the integer kinds
      REPRO_DISPATCH_KEY(key_bytes, K, REPRO_ROWS(kUint, K));
  }
#undef REPRO_ROWS
  return cudaErrorInvalidValue;
}
