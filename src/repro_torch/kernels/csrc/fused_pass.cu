// One whole counting pass in one launch: the port of
// repro/kernels/fused.py::_fused_pass_kernel.
//
// Persistent CTAs (as many as fit the card at once) take flat descriptor
// rows (seg, off, reset, count, active) by ticket.  Per partition row:
//   1. the row's keys come into shared memory with 16-byte vector loads (a
//      scalar head and tail where the row's start is not 16-byte aligned:
//      pass 0 rows always are, later passes' segment-relative rows not);
//      L2 is asked for the row's value leaves at once (a bulk prefetch);
//   2. one walk ranks them stably: each warp walks its contiguous slice 32
//      keys at a time in index order; the lanes of one digit find each
//      other through the warp's shared table of digit bitmasks (one atomicOr
//      each, then one read: cheaper than __match_any_sync when a step holds
//      many distinct digits) and read and bump the warp's running digit
//      count; the counts then become exclusive offsets across warps, so the
//      warp-then-lane order is the keys' index order;
//   3. the row publishes its block histogram and obtains its in-segment
//      carry by decoupled look-back over the earlier rows of its region;
//   4. it stages the row digit-major in shared memory (each key's staged
//      slot kept as uint16, its digit as uint8, or uint16 past r = 256);
//   5. it writes the keys out in runs: staged slot j of digit d goes to
//      base_excl[seg, d] + carry[d] + (j - block_excl[d]), so consecutive
//      threads write consecutive addresses of a digit run (the paper's §4.4
//      write combining), and counts the next pass's digit at (nlo, nwidth),
//      keyed by next_sid[seg * r + digit], into `hist` (and at (n2lo,
//      n2width) into `hist2` with lookahead);
//   6. each value leaf passes through the same staging buffer in turn
//      (coalesced read, permuted in shared memory, written in runs).
// Copy-through rows (active == 0) copy key and values to their own index;
// lanes past `count` write nothing.
//
// The next-pass count runs over the staged tile: the lanes of one (digit,
// next digit) pair of a warp step are merged, and a run of kLongRun keys or
// more merges all its next digits in a shared table first, so a long run
// costs one global atomic per (run, next digit).  (Counting over the keys in
// index order with warp-aggregated global atomics measured slower on every
// pass; PERF.md.)
//
// The TPU ran the grid in order and carried the in-segment offsets in
// scratch.  CTAs here run concurrently and in no order, so a CTA takes its
// next row from a global ticket as it becomes free (every row it may wait
// on has then already started: no deadlock).  The look-back state of each
// (row, digit) is one word, a 2-bit status (0 none, 1 aggregate, 2
// inclusive prefix) over a count, read and written with one relaxed atomic:
// status and count travel together, so no fence orders them, and a step
// back is one load.  The word is 32 bits (30-bit count) when n < 2^30, else
// 64.  Thread d of the CTA follows digit d back, 64 bytes of words per
// round of independent loads, adding aggregates until it meets an inclusive
// prefix; the first row of a region (reset == 1) publishes its inclusive
// prefix at once.  Inert rows (count 0) and copy-through rows never sit
// inside a region, so no chain reaches them.  An inert row is a no-op; a CTA
// that meets one with no live row after it retires (the pads that trail
// every table the planner makes).
// Rows are stable partitions in descriptor order, so the output is
// byte-identical to the reference's sequential carry.
//
// Bound: bytes.  Keys 1R + 1W, every value leaf 1R + 1W, plus the small
// descriptor tables and the (a_max * r) histograms.  What held the first
// version back on this card: a look-back of three arrays with a fence per
// step (pass 0's single 38 837-row region paid it along the whole chain),
// a per-lane scatter into up to 256 buckets, scalar key loads, two
// __match_any_sync per key and a CTA for every pad row.  What bounds this
// one on uniform keys is pass 0's next-pass counts: its rows hold no two
// keys of one (digit, next digit) bin, so each key costs a global atomic
// per histogram.  Shared memory (PassLayout; a shape over the card's
// opt-in limit is refused at launch): keys twice (index order, staged), or
// one leaf, + kpb uint16 slots + kpb staged digits (one byte each up to
// r = 256, two up to 512: the digit type is a template parameter, so the
// 8-bit path keeps its layout) + two (16, r) int tables (the rank's
// per-warp counts and digit bitmasks, then the long runs' next-digit
// tables) + 4 r + 16 ints; at kpb 6912 with 4-byte keys and values
// 110.3 KB at r = 256 (two CTAs of 512 threads per SM) and 155 KB at
// r = 512 (one), with 8-byte keys and 8-byte values 164.3 KB and 210 KB.
// fused_pass_kernel takes d <= 9 (r <= 512: the look-back's thread d still
// follows digit d), kpb <= 2^16 within 227 KB, and up to kMaxLeaves value
// leaves of 1, 2, 4 or 8 bytes.
//
// fused_wide_kernel: the same function for 512 < r <= 65536 (d = 10..16),
// chosen on the host by r.  Three parts of the kernel above grow with r and
// do not fit there: the two (16, r) shared tables (128 KB at r = 1024), the
// dense look-back words (one per (row, digit): 256 KB per row at d = 16,
// 1.6 GB for pass 0's 6 073 descriptor rows at 2^24 keys) and the long
// runs' (16, r) next-digit tables.  So, per partition row:
//   * the rank is stable_digit_order (common.cuh, shared with the
//     multisplit): two stable 8-bit counting rounds in shared memory, the
//     digit's low byte then its high bits, each through warp_mask_rank; the
//     row keeps a uint16 slot -> key order and each slot's digit; the row's
//     histogram is then sparse, one (digit, count) run per distinct digit of
//     the sorted digits (run_starts: at most one run per key);
//   * the in-segment carry is a decoupled look-back over the row's live
//     digits.  As soon as its runs are known a row publishes a bitmap of
//     its live digits (per 32 digits the bits and the popcount before them,
//     8 bytes) and one word per run, run k of row g (runs in digit order) at
//     word blk_off[g] + k: a row has no more runs than keys, so the words
//     are one per key slot, however wide r is.  After a fence and a barrier
//     it release-stores its flag: a set flag says every digit whose bit is
//     0 counts 0 in that row.  One warp then acquires the flags of the rows
//     before it in its region, up to 256 of them, at once (tickets make
//     sure those rows have started, and a row sets its flag before it
//     waits on anything, so there is no deadlock).  Each thread keeps a
//     few of the row's runs walking back at once, a few rows a round in
//     two round trips of independent loads (offsets, reset flags and
//     bitmap entries; then the live digits' words): a 0 bit adds nothing,
//     a live word adds its count and an inclusive word ends the walk, and
//     the region's first row ends it whatever its bit.  A run that ends
//     publishes its inclusive count at once and hands its slot to the
//     thread's next run, in the same run order on every row, so a walk
//     meets an inclusive word within the rows in flight and no run waits
//     for a deeper one.  Scratch is O(rows·r/32 + n), and only the ticket
//     and the flags are zeroed;
//   * the next-pass counts are global atomics into hist / hist2, one per
//     key, or one per warp step whose 32 keys share a (segment, next digit)
//     bin (all-equal keys);
//   * keys go out in runs, staged slot j of run k to delta[k] + j, read
//     through the order from the row staged in index order; each value leaf
//     comes into the same staging buffer with 16-byte loads and leaves the
//     same way.
// It takes kpb <= 2^16 within 227 KB (WideLayout: at kpb 6912 with 4-byte
// keys and leaves 142 KB, and 2 KB of static tables: one CTA of 512
// threads per SM); its words are 32 bits below n = 2^30 and 64 from there,
// as above.
#include <cuda/atomic>

#include "common.cuh"

constexpr int kPassThreads = 512;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kMaxLeaves = 8;
// runs at least this long merge their next digits in shared memory
constexpr int kLongRun = 64;
// long runs per row with a shared next-digit table (the rest: atomics);
// their tables take the place of the per-warp counts after staging
constexpr int kMaxLongRuns = kPassWarps;
static_assert(kMaxLongRuns <= kPassWarps, "long-run tables reuse wcnt");

struct Leaves {
  const void* src[kMaxLeaves];
  void* dst[kMaxLeaves];
  int bytes[kMaxLeaves];
  int count;
};

// ---- look-back words -----------------------------------------------------

template <typename W>
struct Look {
  static constexpr int kShift = sizeof(W) * 8 - 2;
  static constexpr W kAgg = W(1) << kShift;
  static constexpr W kIncl = W(2) << kShift;
  static constexpr W kCount = kAgg - 1;
  static constexpr int kBatch = 64 / sizeof(W);  // loads in flight
};

template <typename W>
__device__ __forceinline__ void publish(W* word, W value) {
  cuda::atomic_ref<W, cuda::thread_scope_device>(*word).store(
      value, cuda::memory_order_relaxed);
}

template <typename W>
__device__ __forceinline__ W peek(W* word) {
  return cuda::atomic_ref<W, cuda::thread_scope_device>(*word).load(
      cuda::memory_order_relaxed);
}

// Digit d's exclusive prefix over the earlier rows of row g's region:
// aggregates of rows g-1, g-2, ... up to and including the first inclusive
// prefix, kBatch words loaded at once; a row not yet published is loaded
// again from there.
template <typename W>
__device__ long long look_back(W* words, int g, int r, int d) {
  using L = Look<W>;
  long long acc = 0;
  int j = g - 1;
  while (true) {
    W w[L::kBatch];
#pragma unroll
    for (int k = 0; k < L::kBatch; ++k)
      w[k] = j - k >= 0 ? peek(words + static_cast<long long>(j - k) * r + d)
                        : L::kIncl;
    int took = 0;
    bool stop = false, done = false;
#pragma unroll
    for (int k = 0; k < L::kBatch; ++k) {
      if (stop) continue;
      const W status = w[k] >> L::kShift;
      if (status == 0) {
        stop = true;
      } else {
        acc += static_cast<long long>(w[k] & L::kCount);
        ++took;
        if (status == 2) stop = done = true;
      }
    }
    if (done) return acc;
    if (took == 0) __nanosleep(32);
    j -= took;
  }
}

// ---- rows ----------------------------------------------------------------

template <typename T>
__device__ void copy_row(const void* src, void* dst, long long off,
                         int count) {
  const T* s = static_cast<const T*>(src) + off;
  T* d = static_cast<T*>(dst) + off;
  for (int i = threadIdx.x; i < count; i += blockDim.x) d[i] = s[i];
}

// One value leaf through the staging buffer: row element i to staged slot
// slot[i], then staged slot j to dst[delta[sdig[j]] + j].
template <typename T, typename D>
__device__ void move_leaf(const void* src, void* dst, long long off,
                          int count, void* stage,
                          const unsigned short* slot, const D* sdig,
                          const int* delta) {
  const T* s = static_cast<const T*>(src) + off;
  T* st = static_cast<T*>(stage);
  __syncthreads();  // the stage buffer's last readers are done
  for (int i = threadIdx.x; i < count; i += blockDim.x) st[slot[i]] = s[i];
  __syncthreads();
  T* d = static_cast<T*>(dst);
  for (int j = threadIdx.x; j < count; j += blockDim.x)
    d[static_cast<long long>(delta[sdig[j]]) + j] = st[j];
}

// Block-exclusive digit offsets and the ids of the long runs that count
// next digits (runid[d] in [0, *nlong) or -1; longd[id] = d), by one warp.
// Digit d's run counts next digits when `counting` and nsid[d] < a_max;
// *live says whether any run of the row does.
__device__ void digit_scan(const int* bhist, const int* nsid, int a_max,
                           bool counting, int r, int* bexcl, int* runid,
                           int* longd, int* nlong, int* live, int lane) {
  const int per = (r + 31) / 32;
  const int d0 = min(r, lane * per), d1 = min(r, d0 + per);
  int sum = 0, longs = 0;
  bool any = false;
  for (int d = d0; d < d1; ++d) {
    sum += bhist[d];
    const bool counted = counting && bhist[d] > 0 && nsid[d] < a_max;
    any |= counted;
    longs += counted && bhist[d] >= kLongRun;
  }
  any = __any_sync(kFullMask, any);
  int incl = sum, lincl = longs;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFullMask, incl, o);
    const int b = __shfl_up_sync(kFullMask, lincl, o);
    if (lane >= o) {
      incl += a;
      lincl += b;
    }
  }
  if (lane == 31) {
    *nlong = min(lincl, kMaxLongRuns);
    *live = any;
  }
  int run = incl - sum, lid = lincl - longs;
  for (int d = d0; d < d1; ++d) {
    bexcl[d] = run;
    run += bhist[d];
    if (counting && bhist[d] >= kLongRun && nsid[d] < a_max &&
        lid < kMaxLongRuns) {
      runid[d] = lid;
      longd[lid] = d;
      ++lid;
    } else {
      runid[d] = -1;
    }
  }
}

// One warp step of the staged next-digit count (every lane calls it; lanes
// with sid >= a_max count nothing): the lanes of one (digit, next digit)
// pair are merged; a long run (rid >= 0) adds into its shared table, a
// short one straight into the global histogram.
__device__ __forceinline__ void staged_count(int* hist, int* table, int sid,
                                             int rid, unsigned d, unsigned nd,
                                             int r, int a_max, int lane) {
  const bool live = sid < a_max;
  const unsigned want = __ballot_sync(kFullMask, live);
  if (!live) return;
  const unsigned peers = __match_any_sync(want, d << 16 | nd);
  if (lane == __ffs(peers) - 1) {
    if (rid >= 0)
      atomicAdd(table + rid * r + nd, __popc(peers));
    else
      atomicAdd(hist + static_cast<long long>(sid) * r + nd, __popc(peers));
  }
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The staged digits' type: one byte up to r = 256, two up to r = 512.
__host__ __device__ constexpr int digit_bytes(int r) {
  return r > 256 ? 2 : 1;
}

// Byte offsets of the shared-memory layout.
struct PassLayout {
  size_t slot, sdig, wcnt, nh2, small, total;
  __host__ __device__ PassLayout(int kpb, int key_bytes, int leaf_bytes,
                                 int r) {
    const size_t k = static_cast<size_t>(kpb);
    size_t region = 2 * k * key_bytes;
    if (k * leaf_bytes > region) region = k * leaf_bytes;
    slot = align16(region);
    sdig = slot + 2 * k;
    wcnt = align16(sdig + k * digit_bytes(r));
    nh2 = wcnt + sizeof(int) * kPassWarps * r;
    small = nh2 + sizeof(int) * kPassWarps * r;
    total = small + sizeof(int) * (4 * r + kMaxLongRuns);
  }
};

// The kernel's arguments, one struct in parameter space.
template <typename K, typename W>
struct PassArgs {
  const K* src_keys;
  K* dst_keys;
  Leaves leaves;
  int leaf_bytes;
  const int* blk_seg;
  const int* blk_off;
  const int* blk_reset;
  const int* blk_count;
  const int* blk_active;
  int rows;
  const int* base_excl;
  const int* next_sid;
  int lo, width, nlo, nwidth, n2lo, n2width, lookahead, r, a_max, kpb;
  int* hist;
  int* hist2;
  int* ticket;
  W* words;         // look-back words: per (row, digit), or (wide) per run
  int* flags;       // fused_wide_kernel: (rows,) published flags
  unsigned long long* bitmap;   // and (rows, r / 32) live-digit bitmaps
};

// Copy-through row: key and every value leaf to their own index.
template <typename K, typename W>
__device__ void copy_through(const PassArgs<K, W>& a, long long off,
                             int count) {
  copy_row<K>(a.src_keys, a.dst_keys, off, count);
  for (int v = 0; v < a.leaves.count; ++v) {
    const void* src = a.leaves.src[v];
    void* dst = a.leaves.dst[v];
    switch (a.leaves.bytes[v]) {
      case 1: copy_row<uint8_t>(src, dst, off, count); break;
      case 2: copy_row<uint16_t>(src, dst, off, count); break;
      case 4: copy_row<uint32_t>(src, dst, off, count); break;
      default: copy_row<unsigned long long>(src, dst, off, count);
    }
  }
}

// Partition row g (active, count > 0) of segment blk_seg[g]; D holds a
// staged digit.
template <typename K, typename W, typename D>
__device__ void partition_row(const PassArgs<K, W>& a, int g, long long off,
                              int count, unsigned char* smem) {
  using L = Look<W>;
  const int r = a.r, kpb = a.kpb, lo = a.lo, width = a.width;
  const PassLayout lay(kpb, sizeof(K), a.leaf_bytes, r);
  K* skeys = reinterpret_cast<K*>(smem);                   // (kpb,) index order
  K* staged = skeys + kpb;                                 // (kpb,) digit-major
  void* vstage = smem;                                     // (kpb,) one leaf
  auto* slot = reinterpret_cast<unsigned short*>(smem + lay.slot);
  D* sdig = reinterpret_cast<D*>(smem + lay.sdig);        // staged digits
  int* wcnt = reinterpret_cast<int*>(smem + lay.wcnt);     // (warps, r)
  int* nh1 = wcnt;                // (long runs, r), after staging
  int* nh2 = reinterpret_cast<int*>(smem + lay.nh2);      // (warps, r): digit
                                  // bitmasks, then (long runs, r)
  int* bhist = reinterpret_cast<int*>(smem + lay.small);  // (r,)
  int* bexcl = bhist + r;                                  // (r,)
  int* delta = bexcl + r;                                  // (r,) carry first
  int* runid = delta + r;                                  // (r,)
  int* longd = runid + r;                                  // (kMaxLongRuns,)
  __shared__ int s_nlong;                                  // long runs used
  __shared__ int s_live;                                   // a run counts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = a.blk_seg[g];
  const bool reset = a.blk_reset[g] != 0;
  const int* bex = a.base_excl + static_cast<long long>(seg) * r;
  const int* nsid = a.next_sid + static_cast<long long>(seg) * r;
  const bool counting = a.nwidth > 0 || (a.lookahead && a.n2width > 0);
  if (tid == 0)   // the value leaves are read last: have L2 fetch them now
    for (int v = 0; v < a.leaves.count; ++v)
      prefetch_l2(a.leaves.src[v], off * a.leaves.bytes[v],
                  (off + count) * a.leaves.bytes[v]);
  for (int i = tid; i < kPassWarps * r; i += blockDim.x) wcnt[i] = nh2[i] = 0;
  load_row<K>(a.src_keys + off, count, skeys);
  __syncthreads();

  // 1. stable in-warp ranks and per-warp digit counts, 32 keys a step
  //    through the warp's table of digit bitmasks (warp_mask_rank)
  const int per = warp_slice_per(count, kPassWarps);
  const int wbeg = warp * per;
  const int wend = min(wbeg + per, count);
  int* mine = wcnt + warp * r;
  unsigned* masks = reinterpret_cast<unsigned*>(nh2) + warp * r;
  for (int base = wbeg; base < wend; base += 32) {
    const int i = base + lane;
    const bool valid = i < wend;
    const unsigned d = valid ? digit_at(skeys[i], lo, width, true) : 0u;
    const int rank = warp_mask_rank(mine, masks, d, valid, lane);
    if (valid) slot[i] = static_cast<unsigned short>(rank);
  }
  __syncthreads();

  // 2. exclusive offsets across warps per digit; block histogram
  warps_exclusive(wcnt, kPassWarps, r, bhist);
  __syncthreads();

  // 3. publish the aggregate (or, first row of a region, the inclusive
  //    prefix) at once, then look back (threads d < r) while the last warp
  //    scans the digits: the inclusive prefix goes out as early as it can,
  //    since every later row of the region may be walking back to it
  const long long row_words = static_cast<long long>(g) * r;
  for (int d = tid; d < r; d += blockDim.x)
    publish(a.words + row_words + d,
            (reset ? L::kIncl : L::kAgg) | static_cast<W>(bhist[d]));
  if (warp == kPassWarps - 1)
    digit_scan(bhist, nsid, a.a_max, counting, r, bexcl, runid, longd,
               &s_nlong, &s_live, lane);
  for (int d = tid; d < r; d += blockDim.x) {
    long long carry = 0;
    if (!reset) {
      carry = look_back(a.words, g, r, d);
      publish(a.words + row_words + d,
              L::kIncl | static_cast<W>(carry + bhist[d]));
    }
    delta[d] = static_cast<int>(carry) + bex[d];
  }
  __syncthreads();
  for (int d = tid; d < r; d += blockDim.x) delta[d] -= bexcl[d];

  // 4. stage digit-major
  for (int i = wbeg + lane; i < wend; i += 32) {
    const K key = skeys[i];
    const unsigned d = digit_at(key, lo, width, true);
    const int s = bexcl[d] + mine[d] + slot[i];
    slot[i] = static_cast<unsigned short>(s);
    staged[s] = key;
    sdig[s] = static_cast<D>(d);
  }
  __syncthreads();
  const int table_ints = s_nlong * r;
  if (table_ints) {    // nh2 is clear: the rank's leaders cleared each mask
    for (int i = tid; i < table_ints; i += blockDim.x) nh1[i] = 0;
    __syncthreads();
  }

  // 5. keys out in runs; next-pass counts over the runs
  for (int base = tid & ~31; base < count; base += blockDim.x) {
    const int j = base + lane;
    const bool valid = j < count;
    unsigned d = 0;
    K key = 0;
    if (valid) {
      d = sdig[j];
      key = staged[j];
      a.dst_keys[static_cast<long long>(delta[d]) + j] = key;
    }
    if (s_live) {
      const int sid = valid ? nsid[d] : a.a_max;
      const int rid = valid ? runid[d] : -1;
      if (a.nwidth > 0)
        staged_count(a.hist, nh1, sid, rid, d,
                     digit_at(key, a.nlo, a.nwidth, true), r, a.a_max, lane);
      if (a.lookahead && a.n2width > 0)
        staged_count(a.hist2, nh2, sid, rid, d,
                     digit_at(key, a.n2lo, a.n2width, true), r, a.a_max,
                     lane);
    }
  }
  __syncthreads();
  if (table_ints) {   // one global atomic per (long run, next digit)
    for (int i = tid; i < table_ints; i += blockDim.x) {
      const int c1 = nh1[i], c2 = a.lookahead ? nh2[i] : 0;
      if (!(c1 | c2)) continue;
      const long long at =
          static_cast<long long>(nsid[longd[i / r]]) * r + i % r;
      if (c1) atomicAdd(a.hist + at, c1);
      if (c2) atomicAdd(a.hist2 + at, c2);
    }
  }

  // 6. each value leaf through the staging buffer
  for (int v = 0; v < a.leaves.count; ++v) {
    const void* src = a.leaves.src[v];
    void* dst = a.leaves.dst[v];
    switch (a.leaves.bytes[v]) {
      case 1: move_leaf<uint8_t, D>(src, dst, off, count, vstage, slot,
                                    sdig, delta); break;
      case 2: move_leaf<uint16_t, D>(src, dst, off, count, vstage, slot,
                                     sdig, delta); break;
      case 4: move_leaf<uint32_t, D>(src, dst, off, count, vstage, slot,
                                     sdig, delta); break;
      default: move_leaf<unsigned long long, D>(src, dst, off, count,
                                                vstage, slot, sdig, delta);
    }
  }
}

// Whether any row from g on has a positive count (the whole CTA calls it;
// 16 independent loads per thread between barriers, so a tail of pads costs
// a few rounds).
__device__ bool live_from(const int* blk_count, int g, int rows) {
  constexpr int kUnroll = 16;
  for (int base = g; base < rows; base += kUnroll * blockDim.x) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      any |= i < rows && __ldg(blk_count + i) > 0;
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}

// Persistent CTAs: each takes a row by ticket as it becomes free, so rows
// start in ticket order and every row a CTA may wait on has started (no
// deadlock).  An inert row (count 0) is a no-op, and ends the CTA when no
// live row follows it.  `partition` runs an active row.
template <typename K, typename W, typename Partition>
__device__ __forceinline__ void take_rows(const PassArgs<K, W>& a,
                                          Partition partition) {
  __shared__ int s_row;
  for (;;) {
    if (threadIdx.x == 0) s_row = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int g = s_row;
    if (g >= a.rows) return;
    const int count = a.blk_count[g];
    const long long off = a.blk_off[g];
    if (count <= 0) {
      if (!live_from(a.blk_count, g + 1, a.rows)) return;
    } else if (a.blk_active[g]) {
      partition(g, off, count);
    } else {
      copy_through(a, off, count);
    }
    __syncthreads();                   // s_row and the shared tables
  }
}

template <typename K, typename W, typename D>
__global__ void __launch_bounds__(kPassThreads, 2)
fused_pass_kernel(const PassArgs<K, W> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  take_rows(a, [&](int g, long long off, int count) {
    partition_row<K, W, D>(a, g, off, count, smem);
  });
}

// ---- the wide variant (512 < r <= 65536) ----------------------------------

// The longest a row waits for an earlier row's flag (about 10 s) before the
// launch fails.
constexpr long long kWaitCycles = 1LL << 34;
// Earlier rows whose flags a row confirms at once before its look-back:
// eight per lane of one warp.
constexpr int kConfirmRows = 256;
// The look-back's two shapes (runs a thread walks at once, rows per round,
// each of the runs' loads in flight together): a row whose region began at
// most kNearRows rows before it takes many runs a short way; others fewer
// runs further (measured, PERF.md §6).
constexpr int kNearRuns = 8, kNearRows = 2;
constexpr int kFarRuns = 2, kFarRows = 8;

// Byte offsets of the wide variant's shared memory: the staging buffer (the
// row's keys in index order, then each leaf), the slot -> key order, the
// rank scratch (then each run's first slot, by run), the sorted digits,
// each slot's run start, each run's destination offset (indexed by its
// first slot), the per-warp counts (then the bitmap's popcount prefix) and
// digit bitmasks (then the row's bitmap of live digits) of the 8-bit
// rounds, their bins and bin starts.
struct WideLayout {
  size_t order, tmp, sdig, rstart, delta, wcnt, masks, bins, total;
  __host__ __device__ WideLayout(int kpb, int key_bytes, int leaf_bytes) {
    const size_t k = static_cast<size_t>(kpb);
    order = align16(k * (key_bytes > leaf_bytes ? key_bytes : leaf_bytes));
    tmp = order + align16(2 * k);
    sdig = tmp + align16(2 * k);
    rstart = sdig + align16(2 * k);
    delta = rstart + align16(2 * k);
    wcnt = delta + align16(sizeof(int) * k);
    masks = wcnt + sizeof(int) * kPassWarps * kRoundBins;
    bins = masks + sizeof(unsigned) * kPassWarps * kRoundBins;
    total = bins + sizeof(int) * 2 * kRoundBins;
  }
};
// the row's bitmap (r / 32 words) and its prefix live in masks and wcnt
static_assert(65536 / 32 <= kPassWarps * kRoundBins, "bitmap fits masks");

// One warp step of the wide next-pass count (every lane calls it): one
// global atomic per live key, or one for the whole step when its 32 keys
// share a bin.
__device__ __forceinline__ void wide_count(int* hist, long long at,
                                           int lane) {
  const long long first = __shfl_sync(kFullMask, at, 0);
  if (__all_sync(kFullMask, at == first)) {
    if (lane == 0 && first >= 0) atomicAdd(hist + first, 32);
  } else if (at >= 0) {
    atomicAdd(hist + at, 1);
  }
}

// One value leaf of the row: into the staging buffer with 16-byte loads,
// then staged slot j's element to dst[delta[rstart[j]] + j].
template <typename T>
__device__ void move_leaf_wide(const void* src, void* dst, long long off,
                               int count, void* stage,
                               const unsigned short* order,
                               const unsigned short* rstart,
                               const int* delta) {
  T* st = static_cast<T*>(stage);
  __syncthreads();  // the stage buffer's last readers are done
  load_row<T>(static_cast<const T*>(src) + off, count, st);
  __syncthreads();
  T* d = static_cast<T*>(dst);
  for (int j = threadIdx.x; j < count; j += blockDim.x)
    d[static_cast<long long>(delta[rstart[j]]) + j] = st[order[j]];
}

// Exclusive prefix of popc(bits[0, nw)) into pre, by the whole block (each
// thread a contiguous range of words); *total gets the sum.  `tops` holds
// one int per warp.
__device__ void popc_exclusive(const unsigned* bits, int* pre, int nw,
                               int* tops, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (nw + blockDim.x - 1) / blockDim.x;
  const int b = min(static_cast<int>(threadIdx.x) * per, nw);
  const int e = min(b + per, nw);
  int own = 0;
  for (int w = b; w < e; ++w) own += __popc(bits[w]);
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) tops[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += tops[w];
  for (int w = b; w < e; ++w) {
    pre[w] = run;
    run += __popc(bits[w]);
  }
  if (threadIdx.x == blockDim.x - 1) *total = run;
}

__device__ __forceinline__ int flag_peek(int* flag) {
  return cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).load(
      cuda::memory_order_relaxed);
}

// Spins until an earlier row's flag is set (the caller then fences): a row
// that never publishes is a broken descriptor table, so the launch fails
// rather than hang the card.
__device__ void wait_flag(int* flag) {
  if (flag_peek(flag)) return;
  const long long t0 = clock64();
  do {
    __nanosleep(32);
    if (clock64() - t0 > kWaitCycles) __trap();
  } while (!flag_peek(flag));
}

// By one warp: waits for the flags of the rows before g in its region, up
// to kConfirmRows of them, with one acquire for them all, and keeps each
// such row's reset flag and offset in win[g - 1 - row].  Returns the
// lowest row so confirmed (the region's first row when it lies within
// reach).
__device__ int confirm_rows(const int* blk_reset, const int* blk_off,
                            int* flags, int g, int lane, int2* win) {
  constexpr int kPer = kConfirmRows / 32;
  const int lo = max(0, g - kConfirmRows);
  int rs[kPer], seen[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {   // one round of independent loads
    const int p = g - 1 - lane - 32 * j;
    rs[j] = p >= lo ? __ldg(blk_reset + p) : 1;
    seen[j] = p >= lo ? flag_peek(flags + p) : 1;
    win[lane + 32 * j] = make_int2(rs[j], p >= lo ? __ldg(blk_off + p) : 0);
  }
  int start = -1;   // the highest row before g that starts a region
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned b = __ballot_sync(kFullMask, rs[j] != 0);
    if (start < 0 && b) start = g - 1 - (__ffs(b) - 1) - 32 * j;
  }
  const int front = start >= 0 ? start : lo;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = g - 1 - lane - 32 * j;
    if (p >= front && !seen[j]) wait_flag(flags + p);
  }
  cuda::atomic_thread_fence(cuda::memory_order_acquire,
                            cuda::thread_scope_device);
  return front;
}

// The in-segment carry of every run of row g by decoupled look-back, the
// runs (in digit order) dealt to the threads in turn.  A thread keeps RUNS
// runs in flight; each walks rows g-1, g-2, ... ROWS a round, in two round
// trips: each row's reset flag and offset (from `win`
// within the confirmed window) and bitmap entry at once (an entry read past
// the region's first row is ignored), then the words of the live digits.
// A row whose bit is 0 adds nothing; a live one adds its word's count, and
// an inclusive word ends the walk; the region's first row ends it whatever
// its bit.  A run that ends publishes its inclusive word and its
// destination base at once, and its slot takes the thread's next run, so
// no run waits for a deeper one.  Rows below `front` are confirmed first
// (their flags awaited) by the round that reaches them.
template <typename W, int RUNS, int ROWS>
__device__ void look_back_runs(const int* blk_reset, const int* blk_off,
                               int* flags, unsigned long long* bitmap,
                               W* words, int nw, int g, int front,
                               const int2* win, const unsigned short* runs,
                               const unsigned short* sdig, int nruns,
                               int count, const int* bex, W* row_words,
                               int* delta) {
  using L = Look<W>;
  int k[RUNS], p[RUNS];
  unsigned dig[RUNS];
  long long acc[RUNS];
  int next = threadIdx.x;
#pragma unroll
  for (int u = 0; u < RUNS; ++u) {
    k[u] = next < nruns ? next : -1;
    dig[u] = next < nruns ? sdig[runs[next]] : 0u;
    p[u] = g - 1;
    acc[u] = 0;
    next += blockDim.x;
  }
  for (;;) {
    bool any = false, deep = false;
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
      any |= k[u] >= 0;
      deep |= k[u] >= 0 && p[u] - ROWS + 1 < front;
    }
    if (!any) return;
    if (deep) {   // rows not yet confirmed: await their flags
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        bool past = k[u] < 0;
        for (int j = 0; j < ROWS && !past; ++j) {
          const int row = p[u] - j;
          if (row < 0) break;
          if (row < front) wait_flag(flags + row);
          past = __ldg(blk_reset + row) != 0;
        }
      }
      cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                cuda::thread_scope_device);
    }
    int rs[RUNS][ROWS], ro[RUNS][ROWS];
    unsigned long long bm[RUNS][ROWS];
#pragma unroll
    for (int u = 0; u < RUNS; ++u)
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int row = p[u] - j;
        const bool live = k[u] >= 0 && row >= 0;
        int2 e = make_int2(1, 0);
        if (live)
          e = g - 1 - row < kConfirmRows
                  ? win[g - 1 - row]
                  : make_int2(__ldg(blk_reset + row), __ldg(blk_off + row));
        rs[u][j] = e.x;
        ro[u][j] = e.y;
        bm[u][j] = live ? peek(bitmap + static_cast<long long>(row) * nw +
                               (dig[u] >> 5))
                        : 0ull;
      }
    W w[RUNS][ROWS];
    unsigned in[RUNS], first[RUNS];   // bit j: row p - j is of
                                    // the region; is its first row
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
      bool past = k[u] < 0;
      in[u] = first[u] = 0;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const bool at = !past && p[u] - j >= 0;
        past |= rs[u][j] != 0;
        in[u] |= static_cast<unsigned>(at) << j;
        first[u] |= static_cast<unsigned>(rs[u][j] != 0) << j;
        const unsigned bits = static_cast<unsigned>(bm[u][j]);
        const unsigned below = bits & lanemask_lt(dig[u] & 31);
        w[u][j] = at && ((bits >> (dig[u] & 31)) & 1u)
                      ? peek(words + static_cast<long long>(ro[u][j]) +
                             static_cast<int>(bm[u][j] >> 32) +
                             __popc(below))
                      : W(0);
      }
    }
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
      if (k[u] < 0) continue;
      bool done = false;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (done) continue;
        if (!((in[u] >> j) & 1u)) {   // before row 0: a broken table; stop
          done = true;
          continue;
        }
        acc[u] += static_cast<long long>(w[u][j] & L::kCount);
        done = (w[u][j] >> L::kShift) == 2 || ((first[u] >> j) & 1u);
      }
      if (!done) {
        p[u] -= ROWS;
        continue;
      }
      const int at = runs[k[u]];
      const int end = k[u] + 1 < nruns ? runs[k[u] + 1] : count;
      publish(row_words + k[u],
              L::kIncl | static_cast<W>(acc[u] + (end - at)));
      delta[at] = bex[dig[u]] + static_cast<int>(acc[u]) - at;
      k[u] = next < nruns ? next : -1;   // the slot's next run
      dig[u] = next < nruns ? sdig[runs[next]] : 0u;
      p[u] = g - 1;
      acc[u] = 0;
      next += blockDim.x;
    }
  }
}

// Partition row g (active, count > 0) of segment blk_seg[g], r > 512.
template <typename K, typename W>
__device__ void partition_row_wide(const PassArgs<K, W>& a, int g,
                                   long long off, int count,
                                   unsigned char* smem) {
  using L = Look<W>;
  const int r = a.r;
  const int nw = r / 32;
  const WideLayout lay(a.kpb, sizeof(K), a.leaf_bytes);
  K* skeys = reinterpret_cast<K*>(smem);                   // index order
  void* stage = smem;                                      // then each leaf
  auto* order = reinterpret_cast<unsigned short*>(smem + lay.order);
  auto* tmp = reinterpret_cast<unsigned short*>(smem + lay.tmp);
  auto* runs = tmp;               // run k's first slot, after the order
  auto* sdig = reinterpret_cast<unsigned short*>(smem + lay.sdig);
  auto* rstart = reinterpret_cast<unsigned short*>(smem + lay.rstart);
  int* delta = reinterpret_cast<int*>(smem + lay.delta);  // by run start
  int* wcnt = reinterpret_cast<int*>(smem + lay.wcnt);
  int* bpre = wcnt;               // after the order: (nw,) popcounts
  auto* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  unsigned* bits = masks;         // after the order: (nw,) live digits
  int* bins = reinterpret_cast<int*>(smem + lay.bins);
  int* bexcl = bins + kRoundBins;
  __shared__ int s_nruns, s_front;
  __shared__ int2 s_win[kConfirmRows];   // confirmed rows' reset, offset

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int seg = a.blk_seg[g];
  const bool reset = a.blk_reset[g] != 0;
  const long long seg_r = static_cast<long long>(seg) * r;
  const int* bex = a.base_excl + seg_r;
  const int* nsid = a.next_sid + seg_r;
  if (tid == 0)   // the value leaves are read last: have L2 fetch them now
    for (int v = 0; v < a.leaves.count; ++v)
      prefetch_l2(a.leaves.src[v], off * a.leaves.bytes[v],
                  (off + count) * a.leaves.bytes[v]);
  for (int i = tid; i < kPassWarps * kRoundBins; i += blockDim.x)
    masks[i] = 0;
  load_row<K>(a.src_keys + off, count, skeys);
  __syncthreads();

  // 1. the row's stable digit-major order, its runs
  stable_digit_order<kPassWarps>(
      count, a.width,
      [&](int i) { return digit_at(skeys[i], a.lo, a.width, true); }, order,
      tmp, sdig, wcnt, masks, bins, bexcl);
  run_starts(sdig, count, rstart, bins);
  __syncthreads();

  // 2. publish at once: the bitmap of the row's live digits (masks is
  //    zero again after the order), each 32 digits' bits beside the
  //    popcount before them; run k (in digit order) gets word off + k,
  //    its count with status AGG (INCL on a region's first row); then,
  //    after a fence and a barrier, the row's flag
  for (int s = tid; s < count; s += blockDim.x)
    if (rstart[s] == s) atomicOr(bits + (sdig[s] >> 5), 1u << (sdig[s] & 31));
  __syncthreads();
  popc_exclusive(bits, bpre, nw, bins, &s_nruns);
  __syncthreads();
  unsigned long long* row_bits = a.bitmap + static_cast<long long>(g) * nw;
  for (int w = tid; w < nw; w += blockDim.x)
    publish(row_bits + w,
            static_cast<unsigned long long>(bpre[w]) << 32 | bits[w]);
  W* row_words = a.words + off;
  for (int s = tid; s < count; s += blockDim.x)
    if (s + 1 == count || sdig[s + 1] != sdig[s]) {   // a run's last slot
      const unsigned d = sdig[s];
      const int first = rstart[s];
      const int k = bpre[d >> 5] + __popc(bits[d >> 5] & lanemask_lt(d & 31));
      runs[k] = static_cast<unsigned short>(first);
      publish(row_words + k,
              (reset ? L::kIncl : L::kAgg) | static_cast<W>(s + 1 - first));
    }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    cuda::atomic_ref<int, cuda::thread_scope_device>(a.flags[g]).store(
        1, cuda::memory_order_release);

  // 3. each run's carry: the look-back over the earlier rows of the
  //    region (none on its first row)
  const int nruns = s_nruns;
  if (reset) {
    for (int k = tid; k < nruns; k += blockDim.x) {
      const int first = runs[k];
      delta[first] = bex[sdig[first]] - first;
    }
  } else {
    if (tid < 32) {
      const int front = confirm_rows(a.blk_reset, a.blk_off, a.flags, g,
                                     lane, s_win);
      if (lane == 0) s_front = front;
    }
    __syncthreads();
    if (g - s_front <= kNearRows)
      look_back_runs<W, kNearRuns, kNearRows>(
          a.blk_reset, a.blk_off, a.flags, a.bitmap, a.words, nw, g, s_front,
          s_win, runs, sdig, nruns, count, bex, row_words, delta);
    else
      look_back_runs<W, kFarRuns, kFarRows>(
          a.blk_reset, a.blk_off, a.flags, a.bitmap, a.words, nw, g, s_front,
          s_win, runs, sdig, nruns, count, bex, row_words, delta);
  }
  __syncthreads();

  // 4. keys out in runs; next-pass counts
  const bool count1 = a.nwidth > 0, count2 = a.lookahead && a.n2width > 0;
  for (int base = tid & ~31; base < count; base += blockDim.x) {
    const int j = base + lane;
    const bool valid = j < count;
    K key = 0;
    int sid = a.a_max;
    if (valid) {
      key = skeys[order[j]];
      a.dst_keys[static_cast<long long>(delta[rstart[j]]) + j] = key;
      sid = nsid[sdig[j]];
    }
    const bool live = sid < a.a_max;
    const long long row = static_cast<long long>(sid) * r;
    if (count1)
      wide_count(a.hist, live ? row + digit_at(key, a.nlo, a.nwidth, true)
                              : -1, lane);
    if (count2)
      wide_count(a.hist2, live ? row + digit_at(key, a.n2lo, a.n2width, true)
                               : -1, lane);
  }

  // 5. each value leaf through the staging buffer
  for (int v = 0; v < a.leaves.count; ++v) {
    const void* src = a.leaves.src[v];
    void* dst = a.leaves.dst[v];
    switch (a.leaves.bytes[v]) {
      case 1: move_leaf_wide<uint8_t>(src, dst, off, count, stage, order,
                                      rstart, delta); break;
      case 2: move_leaf_wide<uint16_t>(src, dst, off, count, stage, order,
                                       rstart, delta); break;
      case 4: move_leaf_wide<uint32_t>(src, dst, off, count, stage, order,
                                       rstart, delta); break;
      default: move_leaf_wide<unsigned long long>(src, dst, off, count,
                                                  stage, order, rstart,
                                                  delta);
    }
  }
}

template <typename K, typename W>
__global__ void __launch_bounds__(kPassThreads, 1)
fused_wide_kernel(const PassArgs<K, W> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  take_rows(a, [&](int g, long long off, int count) {
    partition_row_wide<K, W>(a, g, off, count, smem);
  });
}

REPRO_ERROR_STRING

// A layout over the card's opt-in shared memory per CTA (227 KB on the
// H100) is refused with cudaErrorInvalidValue.  The grid is as many CTAs as
// fit the card at once.
template <typename K, typename W>
cudaError_t launch_persistent(void (*kernel)(const PassArgs<K, W>),
                              const PassArgs<K, W>& a, size_t shmem,
                              cudaStream_t s) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  if (shmem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shmem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPassThreads, shmem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kernel<<<min(a.rows, per_sm * sms), kPassThreads, shmem, s>>>(a);
  return cudaGetLastError();
}

template <typename K, typename W>
cudaError_t launch_pass(const void* src_keys, void* dst_keys,
                        const Leaves& leaves, int leaf_bytes,
                        const int* const* tables, int rows,
                        const int* base_excl, const int* next_sid,
                        const int* windows, int lookahead, int r, int a_max,
                        int kpb, void* hist, void* hist2, void* ticket,
                        void* words, void* flags, void* bitmap,
                        cudaStream_t s) {
  PassArgs<K, W> a{static_cast<const K*>(src_keys), static_cast<K*>(dst_keys),
                   leaves, leaf_bytes, tables[0], tables[1], tables[2],
                   tables[3], tables[4], rows, base_excl, next_sid,
                   windows[0], windows[1], windows[2], windows[3],
                   windows[4], windows[5], lookahead, r, a_max, kpb,
                   static_cast<int*>(hist), static_cast<int*>(hist2),
                   static_cast<int*>(ticket), static_cast<W*>(words),
                   static_cast<int*>(flags),
                   static_cast<unsigned long long*>(bitmap)};
  if (r > 512)
    return launch_persistent(fused_wide_kernel<K, W>, a,
                             WideLayout(kpb, sizeof(K), leaf_bytes).total, s);
  // the 8-bit digits' path does not pay for 16-bit staging
  const size_t shmem = PassLayout(kpb, sizeof(K), leaf_bytes, r).total;
  return r > 256 ? launch_persistent(fused_pass_kernel<K, W, uint16_t>, a,
                                     shmem, s)
                 : launch_persistent(fused_pass_kernel<K, W, uint8_t>, a,
                                     shmem, s);
}

// One fused pass over `rows` flat descriptor rows.  The scratch (laid out
// and sized by the wrapper, kernels/fused.py): `ticket`, one zeroed int;
// for r <= 512 `words`, one zeroed look-back word of `word_bytes` (4 or 8)
// per (row, digit), `flags` and `bitmap` unused; for 512 < r <= 65536
// `flags`, one zeroed int per row, `bitmap`, r / 32 8-byte entries per row,
// and `words`, one look-back word per key slot of the buffers (neither
// needs zeroing: a row writes its whole bitmap, and the words of its live
// digits, before its flag).  hist (and hist2 when lookahead) are zeroed
// (a_max * r,) int32 outputs.
extern "C" int fused_pass_launch(
    const void* src_keys, void* dst_keys, int key_bytes,
    const void* const* val_src, void* const* val_dst, const int* val_bytes,
    int num_vals, const int* blk_seg, const int* blk_off,
    const int* blk_reset, const int* blk_count, const int* blk_active,
    int rows, const int* base_excl, const int* next_sid, int lo, int width,
    int nlo, int nwidth, int n2lo, int n2width, int lookahead, int r,
    int a_max, int kpb, void* hist, void* hist2, void* ticket, void* words,
    void* flags, void* bitmap, int word_bytes, void* stream) {
  if (r < 2 || r > 65536 || num_vals < 0 || num_vals > kMaxLeaves ||
      rows < 1 || kpb < 1 || kpb > 65536 ||
      (word_bytes != 4 && word_bytes != 8) ||
      (r > 512 && (r % 32 != 0 || !flags || !bitmap)))
    return cudaErrorInvalidValue;
  Leaves leaves{};
  leaves.count = num_vals;
  int leaf_bytes = 0;
  for (int v = 0; v < num_vals; ++v) {
    leaves.src[v] = val_src[v];
    leaves.dst[v] = val_dst[v];
    leaves.bytes[v] = val_bytes[v];
    leaf_bytes = max(leaf_bytes, val_bytes[v]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tables[5] = {blk_seg, blk_off, blk_reset, blk_count,
                          blk_active};
  const int windows[6] = {lo, width, nlo, nwidth, n2lo, n2width};
  REPRO_DISPATCH_KEY(key_bytes, K, {
    return static_cast<int>(
        word_bytes == 4
            ? launch_pass<K, uint32_t>(
                  src_keys, dst_keys, leaves, leaf_bytes, tables, rows,
                  base_excl, next_sid, windows, lookahead, r, a_max, kpb,
                  hist, hist2, ticket, words, flags, bitmap, s)
            : launch_pass<K, unsigned long long>(
                  src_keys, dst_keys, leaves, leaf_bytes, tables, rows,
                  base_excl, next_sid, windows, lookahead, r, a_max, kpb,
                  hist, hist2, ticket, words, flags, bitmap, s));
  })
  return static_cast<int>(cudaErrorInvalidValue);
}
