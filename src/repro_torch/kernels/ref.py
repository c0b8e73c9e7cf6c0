"""Plain PyTorch versions of the CUDA kernels (the correctness ground truth).

Each function has exactly its kernel's contract: the same tables, the same
padded buffers and outputs.  The wrappers run them for tensors that lie on
the CPU (the kernel engine's path in the CPU tests), and ``chip_smoke.py``
holds every kernel to them on the card.  They favour clarity and O(n)
memory over speed; they are no yardstick of speed.

Keys are in the port's carrier (see ``core.bijection``): digits come from
``(carrier >> lo) & mask`` and order from ``sortable(carrier)``.

The trash slot: the fused pass writes every position ``[0, n)`` of its
output buffers; the kernel and this version both leave slot ``n`` and the
padding after it unspecified (the reference scattered masked lanes there).
"""
from __future__ import annotations

import torch

from repro_torch.core.bijection import sortable


def _digits(keys: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    # widen before masking: an 8-bit mask does not fit an int8 carrier
    return (keys >> lo).to(torch.int64) & ((1 << width) - 1)


def radix_histogram_ref(keys: torch.Tensor, shift: int,
                        width: int) -> torch.Tensor:
    """(T, KPB) carrier keys -> (T, 2^width) int32 per-tile digit counts."""
    t = keys.shape[0]
    r = 1 << width
    rows = torch.arange(t, device=keys.device).unsqueeze(1)
    flat = (rows * r + _digits(keys, shift, width)).reshape(-1)
    out = torch.zeros(t * r, dtype=torch.int32, device=keys.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.reshape(t, r)


def _lanes(starts: torch.Tensor, counts: torch.Tensor):
    """Flatten rows of (start, count) into per-lane (row, position)."""
    counts = counts.to(torch.int64)
    row = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    excl = torch.cumsum(counts, 0) - counts
    lane = torch.arange(row.shape[0], device=counts.device) - excl[row]
    return row, starts.to(torch.int64)[row] + lane


def fused_counting_pass_ref(src_keys, src_vals, alt_keys, alt_vals, sc,
                            blk_seg, blk_off, blk_reset, blk_count,
                            blk_active, base_excl, next_sid, *, kpb: int,
                            r: int, a_max: int, n: int,
                            lookahead: bool = False):
    """One counting pass over flat descriptor rows (see ``fused.py``).

    Writes the partitioned keys and values into the alternate buffers and
    returns ``(alt_keys, alt_vals, hist[, hist2])``.  ``sc`` is the 6-tuple
    of digit windows.  Every row's lanes are flattened (the rows partition
    ``[0, n)``), ranked stably per (row, digit) with one stable sort, and
    given their in-segment carry from an exclusive sum over the earlier rows
    of their region.
    """
    lo, width, nlo, nwidth, n2lo, n2width = (list(sc) + [0, 0])[:6]
    dev = src_keys.device
    seg, off, reset, count, active = (t.reshape(-1).to(torch.int64) for t in
                                      (blk_seg, blk_off, blk_reset,
                                       blk_count, blk_active))
    rows = torch.nonzero(count > 0).squeeze(1)
    nrows = rows.shape[0]
    row, pos = _lanes(off[rows], count[rows])
    keys = src_keys[pos]
    act = active[rows][row] == 1
    dest = pos.clone()

    hists = [torch.zeros(a_max * r, dtype=torch.int32, device=dev)
             for _ in range(2 if lookahead else 1)]
    a_row, a_key = row[act], keys[act]
    digit = _digits(a_key, lo, width)
    comp = a_row * r + digit
    bh = torch.zeros(nrows * r, dtype=torch.int64, device=dev)
    bh.index_add_(0, comp, torch.ones_like(comp))
    order = torch.sort(comp, stable=True).indices
    group_start = torch.cumsum(bh, 0) - bh
    rank = torch.empty_like(comp)
    rank[order] = (torch.arange(comp.shape[0], device=dev) -
                   group_start[comp[order]])
    # in-segment carry: exclusive running sum of block histograms over the
    # earlier rows of the same region (a region restarts where reset == 1)
    bh = bh.reshape(nrows, r)
    excl = torch.cumsum(bh, 0) - bh
    idx = torch.arange(nrows, device=dev)
    first = torch.cummax(torch.where(reset[rows] == 1, idx,
                                     torch.zeros_like(idx)), 0).values
    carry = excl - excl[first]
    a_seg = seg[rows][a_row]
    dest[act] = (base_excl.reshape(-1).to(torch.int64)[a_seg * r + digit] +
                 carry[a_row, digit] + rank)

    alt_keys[dest] = keys
    for sv, dv in zip(src_vals, alt_vals):
        dv[dest] = sv[pos]

    sid = next_sid.reshape(-1).to(torch.int64)[a_seg * r + digit]
    for h, (wlo, wid) in zip(hists, ((nlo, nwidth), (n2lo, n2width))):
        if wid > 0:
            live = sid < a_max
            bins = sid[live] * r + _digits(a_key[live], wlo, wid)
            h.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    return (alt_keys, tuple(alt_vals), *hists)


def bitonic_sort_rows_stable_ref(keys: torch.Tensor, idx: torch.Tensor):
    """Sort (S, L) rows by (key, idx) lexicographically."""
    o1 = torch.sort(idx, dim=1, stable=True).indices
    k1, i1 = torch.gather(keys, 1, o1), torch.gather(idx, 1, o1)
    o2 = torch.sort(sortable(k1), dim=1, stable=True).indices
    return torch.gather(k1, 1, o2), torch.gather(i1, 1, o2)


def sort_segments_ref(buf: torch.Tensor, perm, starts: torch.Tensor,
                      sizes: torch.Tensor, length: int) -> None:
    """Sort each bucket ``buf[start:start+size]`` (size <= length) in place
    by (key, position); write source positions into ``perm`` if given."""
    live = sizes > 0
    row, pos = _lanes(starts[live], sizes[live])
    keys = buf[pos]
    o1 = torch.sort(sortable(keys), stable=True).indices
    order = o1[torch.sort(row[o1], stable=True).indices]
    buf[pos] = keys[order]
    if perm is not None:
        perm[pos] = pos[order].to(perm.dtype)


def merge_rows_ref(hist: torch.Tensor, local_threshold: int,
                   merge_threshold: int):
    """R3 over each (A, r) row: (group_start, group_done) bool tables."""
    acc = torch.full((hist.shape[0],), merge_threshold, dtype=torch.int32,
                     device=hist.device)
    gstart = torch.empty(hist.shape, dtype=torch.bool, device=hist.device)
    gdone = torch.empty_like(gstart)
    for v in range(hist.shape[1]):
        s = hist[:, v]
        big = s > local_threshold
        extend = (s == 0) | (~big & (acc + s < merge_threshold))
        acc = torch.where(extend, acc + s,
                          torch.where(big, merge_threshold, s))
        gstart[:, v] = ~extend
        gdone[:, v] = ~big
    return gstart, gdone


def _tile_rank_ref(skeys, live, takes, *, kway: int, tpb: int, rank: str):
    """Rank of every window element under (key, run, lane) order.

    ``skeys`` (G, kway, tpb) are the windows in the ``sortable`` domain,
    ``live`` their live-lane mask (a prefix of each window), ``takes``
    (G, kway) the live counts.  Returns (G, kway * tpb) int64 ranks, exact
    for live elements and arbitrary for dead ones.  ``"searchsorted"``: own
    lane + per run-pair binary searches (<= in earlier runs, < in later
    ones); ``"counting"``: the all-pairs comparison rank.
    """
    g = skeys.shape[0]
    kf = skeys.reshape(g, kway * tpb)
    flat = torch.arange(kway * tpb, device=skeys.device)
    if rank == "counting":
        lf = live.reshape(g, kway * tpb)
        before = lf[:, None, :] & (
            (kf[:, None, :] < kf[:, :, None]) |
            ((kf[:, None, :] == kf[:, :, None]) &
             (flat[None, :] < flat[:, None])))
        return before.sum(dim=2)
    # dead lanes mask to the all-ones sentinel (the sortable maximum), so
    # every row stays sorted; counts clip to the live prefix
    win = torch.where(live, skeys, torch.iinfo(skeys.dtype).max)
    run_of = flat // tpb
    out = (flat % tpb).expand(g, -1).clone()
    for r in range(kway):
        row = win[:, r, :].contiguous()
        le = torch.searchsorted(row, kf, side="right", out_int32=True)
        lt = torch.searchsorted(row, kf, side="left", out_int32=True)
        c = torch.where(run_of > r, le, torch.where(run_of < r, lt, 0))
        out += torch.minimum(c, takes[:, r:r + 1].to(c.dtype))
    return out


def kway_merge_round_ref(src_keys, src_vals, alt_keys, alt_vals, out_off,
                         out_cnt, win_start, win_take, *, kway: int, tpb: int,
                         n: int, rank: str = "searchsorted"):
    """One k-way merge round over descriptor tables (see ``merge.py``).

    Grid step g loads ``kway`` windows of ``tpb`` lanes at
    ``win_start[g*kway + r]`` (live lanes: the prefix ``< win_take``),
    ranks every element under (key, run, lane) order and writes key and
    value leaves to ``out_off[g] + rank`` when live and ``rank <
    out_cnt[g]``, else to the trash slot ``n``.  The buffers are
    ``pad_length``-sized, so every window load stays in bounds.  Tiles are
    processed in blocks of about 2^22 window lanes, so memory stays bounded
    at any n.  Returns ``(alt_keys, alt_vals)``, written in place.
    """
    if rank not in ("searchsorted", "counting"):
        raise ValueError(f"unknown tile rank mode {rank!r}")
    g_all = out_off.shape[0]
    dev = src_keys.device
    lane = torch.arange(tpb, device=dev)
    lanes = kway * tpb
    block = max(1, (1 << 22) // (lanes * (lanes if rank == "counting" else 1)))
    for g0 in range(0, g_all, block):
        g1 = min(g0 + block, g_all)
        g = g1 - g0
        starts = win_start.reshape(g_all, kway)[g0:g1].to(torch.int64)
        takes = win_take.reshape(g_all, kway)[g0:g1].to(torch.int64)
        pos = (starts[:, :, None] + lane).reshape(-1)
        keys = src_keys[pos]
        live = lane < takes[:, :, None]
        ranks = _tile_rank_ref(sortable(keys).reshape(g, kway, tpb), live,
                               takes, kway=kway, tpb=tpb, rank=rank)
        ok = live.reshape(g, -1) & (
            ranks < out_cnt[g0:g1].to(torch.int64)[:, None])
        dest = torch.where(ok, out_off[g0:g1].to(torch.int64)[:, None] +
                           ranks, n).reshape(-1)
        alt_keys[dest] = keys
        for sv, dv in zip(src_vals, alt_vals):
            dv[dest] = sv[pos]
    return alt_keys, tuple(alt_vals)
