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
    return ((keys >> lo) & ((1 << width) - 1)).to(torch.int64)


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
