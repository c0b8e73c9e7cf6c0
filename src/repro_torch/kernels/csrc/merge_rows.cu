// R3 merge bookkeeping of one pass: the port of repro/core/plan.py::merge_rows,
// a lax.scan over the r sub-bucket sizes of every active bucket (not a
// Pallas kernel in the reference).  The recurrence is sequential within a
// row, but it resolves 32 digits at a time: one warp takes a row, 128
// digits a step in four coalesced loads of 32, the next step's loads in
// flight while this one resolves.  The running sum `acc` is uniform across
// the warp.  Per 32 digits, with the inclusive sums of the sizes:
//   * the forced group starts are known apart from acc: a non-zero size
//     that is big or at least merge_threshold starts a group whatever acc
//     holds, and leaves acc at or above merge_threshold, so the next
//     non-zero size starts one too (pass 0's single row is all big sizes
//     at d = 8 and 12); that work, the sums, and where acc stands after
//     each forced start are done for the four steps side by side, with no
//     branch between them (a step of 128 zeros skips it: they all extend);
//   * the other starts take one ballot round each on the serial path: the
//     first lane whose size takes acc, counted from the last start before
//     it, to merge_threshold; acc restarts at its size and the search
//     resumes after it;
//   * gdone is !big on every lane.
// Each lane writes the two byte tables for 4 digits with one 32-bit store
// each.
//
// Bound: bytes — the (rows, r) int32 histogram read once and two (rows, r)
// byte tables written once, 6 bytes per digit.  What held the first version
// back: one thread walked each row's r counts, its lanes a row apart (no
// access coalesced), 1 821 threads for the 65 536 counts of a d = 16 row.
// At d = 16 (one dense row of 65 536 and 1 820 rows of zeros) it takes
// about 4x its bound: the rows of zeros alone take 1.7x the bound, and the
// dense row's one warp, a ballot round a start, the rest (PERF.md §6).
#include "common.cuh"

constexpr int kRowWarps = 8;   // rows (warps) per CTA

// Bits 0..3 of m as bytes 0..3 (each 0 or 1).
__device__ __forceinline__ unsigned spread4(unsigned m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

// T holds the sums: int with every size clamped to `cap` = merge_threshold
// (0 < merge_threshold <= 2^25, so 33 of them fit; 8-16 % faster than
// long long, PERF.md §6), or long long with no clamp for other thresholds.
// A clamped size changes no outcome: a size at or above merge_threshold
// starts a group whatever acc holds.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
merge_rows_kernel(const int* __restrict__ hist, int rows, int r,
                  int local_threshold, int merge_threshold, T cap,
                  uint8_t* __restrict__ gstart, uint8_t* __restrict__ gdone) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp
  const long long at = static_cast<long long>(row) * r;
  const int* h = hist + at;
  const T mt = merge_threshold;
  const unsigned lt_mask = lanemask_lt(lane);
  T acc = mt;   // uniform across the warp
  int s[4], nxt[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int v = 32 * e + lane;
    s[e] = v < r ? __ldg(h + v) : 0;
  }
  for (int v0 = 0; v0 < r; v0 += 128) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = v0 + 128 + 32 * e + lane;
      nxt[e] = v < r ? __ldg(h + v) : 0;
    }
    unsigned st[4], dn[4], nz[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool big = v0 + 32 * e + lane < r && s[e] > local_threshold;
      dn[e] = __ballot_sync(kFullMask, !big);
      nz[e] = __ballot_sync(kFullMask, s[e] != 0);
      st[e] = 0;
    }
    if (nz[0] | nz[1] | nz[2] | nz[3]) {
      // what does not depend on acc, the four steps side by side and
      // branch-free: forced starts, inclusive sums, acc after the last
      // forced start before each lane (less the sum up to it) and after
      // the step's last forced start
      unsigned fm[4], bg[4], hv[4];
      T xc[4], incl[4], tail[4], fbase[4], lbase[4];
      int myf[4], fl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = s[e];
        const bool big = v0 + 32 * e + lane < r && x > local_threshold;
        bg[e] = __ballot_sync(kFullMask, x != 0 && big);
        hv[e] = __ballot_sync(kFullMask, x != 0 && (big || x >= mt));
        xc[e] = x < cap ? T(x) : cap;
        incl[e] = xc[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned prev = nz[e] & lt_mask;
        fm[e] = __ballot_sync(kFullMask, s[e] != 0 && (((hv[e] >> lane) & 1u)
            || (prev && ((hv[e] >> (31 - __clz(prev))) & 1u))));
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T up = __shfl_up_sync(kFullMask, incl[e], o);
          if (lane >= o) incl[e] += up;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tail[e] = __shfl_sync(kFullMask, incl[e], 31);
        const unsigned fb = fm[e] & lt_mask;
        const int f = fb ? 31 - __clz(fb) : 0;
        const T xf = __shfl_sync(kFullMask, xc[e], f);
        const T inf = __shfl_sync(kFullMask, incl[e], f);
        fbase[e] = ((bg[e] >> f) & 1u ? mt : xf) - inf;
        myf[e] = fb ? f : -1;
        fl[e] = fm[e] ? 31 - __clz(fm[e]) : -1;
        const int l = fl[e] < 0 ? 0 : fl[e];
        const T xl = __shfl_sync(kFullMask, xc[e], l);
        const T il = __shfl_sync(kFullMask, incl[e], l);
        lbase[e] = ((bg[e] >> l) & 1u ? mt : xl) - il;
      }
      // then step by step, the other starts, one ballot round each
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!nz[e]) continue;
        const bool forced = (fm[e] >> lane) & 1u;
        T off = acc;   // acc before the stretch, less incl before it
        unsigned starts = fm[e];
        int from = 0;
        for (;;) {
          const bool brk = lane >= from && s[e] != 0 && !forced &&
                           (myf[e] >= from ? fbase[e] : off) + incl[e] >= mt;
          const unsigned m = __ballot_sync(kFullMask, brk);
          if (!m) break;
          const int b = __ffs(m) - 1;
          starts |= 1u << b;
          off = __shfl_sync(kFullMask, xc[e] - incl[e], b);
          from = b + 1;
        }
        st[e] = starts;
        acc = (fl[e] >= from ? lbase[e] : off) + tail[e];
      }
    }
    // this lane's digits v0 + 4 lane .. + 3: step lane / 8, bits 4 (lane % 8)
    const int e = lane >> 3, sh = 4 * (lane & 7);
    const unsigned ms =
        (e == 0 ? st[0] : e == 1 ? st[1] : e == 2 ? st[2] : st[3]) >> sh;
    const unsigned md =
        (e == 0 ? dn[0] : e == 1 ? dn[1] : e == 2 ? dn[2] : dn[3]) >> sh;
    const int v = v0 + 4 * lane;
    if (r % 4 == 0 && v + 4 <= r) {
      *reinterpret_cast<unsigned*>(gstart + at + v) = spread4(ms);
      *reinterpret_cast<unsigned*>(gdone + at + v) = spread4(md);
    } else {
      for (int i = 0; i < 4 && v + i < r; ++i) {
        gstart[at + v + i] = (ms >> i) & 1u;
        gdone[at + v + i] = (md >> i) & 1u;
      }
    }
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) s[e2] = nxt[e2];
  }
}

REPRO_ERROR_STRING

extern "C" int merge_rows_launch(const void* hist, int rows, int r,
                                 int local_threshold, int merge_threshold,
                                 void* gstart, void* gdone, void* stream) {
  if (rows < 1 || r < 1) return cudaErrorInvalidValue;
  const int blocks = (rows + kRowWarps - 1) / kRowWarps;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* h = static_cast<const int*>(hist);
  auto* a = static_cast<uint8_t*>(gstart);
  auto* b = static_cast<uint8_t*>(gdone);
  if (merge_threshold > 0 && merge_threshold <= (1 << 25))
    merge_rows_kernel<int><<<blocks, kRowWarps * 32, 0, s>>>(
        h, rows, r, local_threshold, merge_threshold, merge_threshold, a, b);
  else
    merge_rows_kernel<long long><<<blocks, kRowWarps * 32, 0, s>>>(
        h, rows, r, local_threshold, merge_threshold, 1LL << 40, a, b);
  return static_cast<int>(cudaGetLastError());
}
