"""Pass plan: port of ``repro.core.plan`` as the sorts use it — digit
windows (MSD and LSD), active-segment descriptors, block descriptor tables,
R3 merge bookkeeping, the next-pass segment map, the bucket-state updates
after a pass, and ``single_pass_partition``, the one stable counting pass
under ``segmented.counting_partition``.

Bucket state takes two forms.  The plain engines (``argsort``, ``scan``)
rank keys by (active segment, digit), so they keep it dense per key
(segment ids + done flags: ``active_segments``,
``apply_pass_bookkeeping``).  The kernel engine reads it only through
tables of at most s_max rows, so it keeps a ``SegmentTable`` of one row
per bucket (``segment_table``, ``table_active``, ``advance_table``) and
no step of its plan reads or writes per key.

Every table keeps the reference's static size (a_max, g_max, ...) so it
compares with the reference entry for entry.  The ``jnp.nonzero(size=)``
sites use ``kernels.ops.static_nonzero`` (no host read), and every
``cumsum`` is pinned to int32 so no per-key temporary widens to int64.
``merge_rows`` is a CUDA kernel on the card (one warp per active row,
resolving the R3 recurrence 32 sub-buckets at a time: ``csrc/merge_rows.cu``)
and a plain loop on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.ranks import (invert_permutation, resolve_engine,
                                    stable_partition_dest)
from repro_torch.kernels import _build, fused, ref
from repro_torch.kernels.ops import static_nonzero

_I32 = torch.int32


class ActiveSegments(NamedTuple):
    """Dense descriptors of the active (> ∂̂) buckets, in position order."""
    base: torch.Tensor      # (a_max,) first key of each active segment; n pad
    size: torch.Tensor      # (a_max,) keys per active segment; 0 pad
    index: torch.Tensor     # (n,) compact active-segment id per key
    boundary: torch.Tensor  # (n,) bool: first key of any bucket
    # (index and boundary are the plain engines' per-key arrays: None from
    # a SegmentTable)


class SegmentTable(NamedTuple):
    """The kernel engine's bucket state: one row per bucket in position
    order, s_max rows (``model.max_total_buckets``).  The buckets tile
    [0, n); padding rows follow them with ``start == n``, ``size == 0`` and
    ``done`` False."""
    start: torch.Tensor  # (s_max,) int32 first key of the bucket
    size: torch.Tensor   # (s_max,) int32 keys in the bucket
    done: torch.Tensor   # (s_max,) bool: at most ∂̂ keys, for the local sort


class RegionBlocks(NamedTuple):
    """Block descriptor tables of one fused launch (§4.2): one row per KPB
    block of an active segment (partitioned) or of a done gap (copied
    through); padding rows carry ``count == 0``."""
    seg: torch.Tensor     # compact active-segment id; a_max for copies/pads
    offset: torch.Tensor  # absolute offset of the block's first key
    reset: torch.Tensor   # 1 = first block of its region (carry reset)
    count: torch.Tensor   # live lanes in the block
    active: torch.Tensor  # 1 = partition block, 0 = copy-through block


def digit_at(ukeys: torch.Tensor, pass_idx: int, k: int, d: int,
             lo: int = 0) -> torch.Tensor:
    """MSD digit of pass ``pass_idx`` as int32 (0 = most significant)."""
    hi = k - pass_idx * d
    width = max(0, min(d, hi - lo))
    # widen before masking: an 8-bit mask does not fit an int8 carrier
    return (ukeys >> (hi - width)).to(_I32) & ((1 << width) - 1)


def digit_window(pass_idx: int, k: int, d: int, lo: int = 0) -> tuple:
    """``(lo, width, next_lo, next_width, next2_lo, next2_width)`` of a pass:
    this pass's digit, the next pass's (the fused histogram) and the one
    after (the adaptive lookahead); width 0 marks a window past the end."""
    hi = k - pass_idx * d
    width = max(0, min(d, hi - lo))
    wlo = hi - width
    nwidth = max(0, min(d, wlo - lo))
    nlo = wlo - nwidth
    n2width = max(0, min(d, nlo - lo))
    return (wlo, width, nlo, nwidth, nlo - n2width, n2width)


def lsd_digit_window(pass_idx: int, k: int, d: int, lo: int = 0) -> tuple:
    """LSD windows of a pass in ``digit_window``'s layout: pass p covers
    bits [lo + p·d, min(lo + (p+1)·d, k)), counted from the bottom; the
    next pair is the pass after it (the fused histogram); the lookahead
    slots are 0, since the LSD sort unrolls its passes and never elides
    one mid-sort."""
    wlo = lo + pass_idx * d
    width = min(d, k - wlo)
    nlo = wlo + width
    nwidth = max(0, min(d, k - nlo))
    return (wlo, width, nlo, nwidth, 0, 0)


def active_segments(seg_id: torch.Tensor, done: torch.Tensor,
                    a_max: int) -> ActiveSegments:
    """Derive the active-segment descriptors from dense per-key state (the
    plain engines').

    A bucket is done or active as a whole and segment ids never decrease
    along the keys, so an active segment ends where its id ends: its size
    comes from a binary search over ``seg_id`` per segment, not from a
    count over every key (which on the card piles all keys of one big
    segment onto one atomic counter).
    """
    n = seg_id.shape[0]
    boundary = torch.ones(n, dtype=torch.bool, device=seg_id.device)
    boundary[1:] = seg_id[1:] != seg_id[:-1]
    astart = boundary & ~done
    asid = torch.cumsum(astart, 0, dtype=_I32) - 1
    base = static_nonzero(astart, a_max, n)
    first = seg_id[torch.clamp(base, max=n - 1).to(torch.int64)]
    end = torch.searchsorted(seg_id, first, right=True).to(_I32)
    size = torch.where(base < n, end - base, 0)
    return ActiveSegments(base=base, size=size, index=asid,
                          boundary=boundary)


def segment_table(n: int, s_max: int, done: bool, device) -> SegmentTable:
    """The table of one bucket [0, n), done when ``done`` (n ≤ ∂̂)."""
    start = torch.full((s_max,), n, dtype=_I32, device=device)
    start[0] = 0
    size = torch.zeros(s_max, dtype=_I32, device=device)
    size[0] = n
    flags = torch.zeros(s_max, dtype=torch.bool, device=device)
    flags[0] = done
    return SegmentTable(start, size, flags)


def _active_rows(table: SegmentTable) -> torch.Tensor:
    return ~table.done & (table.size > 0)


def table_any_active(table: SegmentTable) -> torch.Tensor:
    """Device bool: some bucket of the table is still active."""
    return _active_rows(table).any()


def table_active(table: SegmentTable, n: int, a_max: int) -> tuple:
    """``(asegs, rows)``: the active buckets' ``ActiveSegments`` (base and
    size padded with ``n`` and 0; no per-key ``index`` or ``boundary``) and
    the table row of each (s_max pad).  One scan over the table's rows."""
    s_max = table.start.shape[0]
    rows = static_nonzero(_active_rows(table), a_max, s_max)
    found = rows < s_max
    sel = torch.clamp(rows, max=s_max - 1).to(torch.int64)
    base = torch.where(found, table.start[sel], n)
    size = torch.where(found, table.size[sel], 0)
    return ActiveSegments(base=base, size=size, index=None,
                          boundary=None), rows


def advance_table(table: SegmentTable, rows: torch.Tensor, gstart, gdone,
                  dest_base, n: int) -> SegmentTable:
    """The table after a counting pass, from the (a_max, r) tables alone.

    A done bucket keeps its row.  Active bucket a (table row ``rows[a]``)
    becomes one bucket per merged group (R3) it starts: for each v with
    ``gstart[a, v]``, ``start = dest_base[a, v]`` and ``done = gdone[a, v]``.
    R3 starts a group at a row's first non-empty sub-bucket and never at an
    empty one, so the buckets still tile [0, n) and each size is the
    distance to the next start.  A bucket's new row counts the done rows
    and the groups before it: O(s_max + a_max·r), no sort, and no scatter
    index twice (rows that write nothing go to their own slot past s_max).
    """
    s_max = table.start.shape[0]
    a_max, r = gstart.shape
    dev = table.start.device
    slot = torch.arange(s_max, dtype=torch.int64, device=dev)
    dump = slot + s_max
    act = _active_rows(table).to(_I32)
    before = (torch.cumsum(act, 0, dtype=_I32) - act).to(torch.int64)
    groups = torch.cumsum(gstart.sum(1, dtype=_I32), 0, dtype=_I32)
    gbefore = torch.cat([groups.new_zeros(1), groups])    # (a_max + 1,)
    start = torch.full((2 * s_max,), n, dtype=_I32, device=dev)
    done = torch.zeros(2 * s_max, dtype=torch.bool, device=dev)

    # done row i: after the done rows and the groups of the active rows
    # before it
    dst = torch.where(table.done, slot - before + gbefore[before], dump)
    start[dst] = table.start
    done[dst] = table.done

    # the j-th group start, in position order, of active bucket a: after
    # the j groups before it and the rows[a] - a done rows before its bucket
    flat = static_nonzero(gstart.reshape(-1), s_max, a_max * r)
    found = flat < a_max * r
    flat = torch.clamp(flat, max=a_max * r - 1).to(torch.int64)
    a = flat // r
    dst = torch.where(found, slot + rows[a].to(torch.int64) - a, dump)
    start[dst] = dest_base.reshape(-1).to(_I32)[flat]
    done[dst] = gdone.reshape(-1)[flat]

    start = start[:s_max]
    size = torch.cat([start[1:], start.new_full((1,), n)]) - start
    return SegmentTable(start, size, done[:s_max])


def max_region_blocks(n: int, kpb: int, a_max: int) -> int:
    """Static bound on descriptor rows: ⌊n/KPB⌋ full blocks + one partial
    per active segment + one per gap."""
    return n // kpb + 2 * a_max + 2


def pack_region_blocks(blocks: RegionBlocks, batch: int,
                       seg_pad: int = None) -> RegionBlocks:
    """Pack flat rows into (G', B) super-steps in descriptor order, the tail
    padded with inert rows (count 0, copy-through, carry-reset)."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    g = blocks.seg.shape[0]
    pad = (-g) % batch
    fills = dict(seg=0 if seg_pad is None else seg_pad, offset=0, reset=1,
                 count=0, active=0)
    packed = {}
    for name, fill in fills.items():
        t = getattr(blocks, name)
        if pad:
            t = torch.cat([t, t.new_full((pad,), fill)])
        packed[name] = t.reshape(-1, batch)
    return RegionBlocks(**packed)


def make_region_blocks(base: torch.Tensor, size: torch.Tensor, n: int,
                       kpb: int, g_max: int, batch: int = None) -> RegionBlocks:
    """Chop active segments and the done gaps between them into KPB blocks.

    Regions interleave gap_0, active_0, gap_1, ..., tail gap; every key
    position lands in exactly one block.  With ``batch`` the flat rows are
    packed into (⌈g_max/batch⌉, batch) super-steps.
    """
    dev = base.device
    a_max = base.shape[0]
    nreg = 2 * a_max + 1
    base = base.to(_I32)
    size = size.to(_I32)
    ends = base + size
    prev_end = torch.cat([torch.zeros(1, dtype=_I32, device=dev), ends[:-1]])

    rbase = torch.zeros(nreg, dtype=_I32, device=dev)
    rbase[0:2 * a_max:2] = prev_end
    rbase[1:2 * a_max:2] = base
    rbase[2 * a_max] = ends[-1]
    rsize = torch.zeros(nreg, dtype=_I32, device=dev)
    rsize[0:2 * a_max:2] = torch.clamp(base - prev_end, min=0)
    rsize[1:2 * a_max:2] = size
    rsize[2 * a_max] = torch.clamp(n - ends[-1], min=0)
    ract = torch.zeros(nreg, dtype=_I32, device=dev)
    ract[1:2 * a_max:2] = 1
    rseg = torch.full((nreg,), a_max, dtype=_I32, device=dev)
    rseg[1:2 * a_max:2] = torch.arange(a_max, dtype=_I32, device=dev)

    # block ownership via marks + prefix sum (the paper's M4 generation)
    nblk = (rsize + kpb - 1) // kpb
    blk_excl = torch.cumsum(nblk, 0, dtype=_I32) - nblk
    total = blk_excl[-1] + nblk[-1]
    marks = torch.zeros(g_max + 1, dtype=_I32, device=dev)
    slot = torch.where((nblk > 0) & (blk_excl < g_max), blk_excl, g_max)
    marks.index_add_(0, slot, torch.ones_like(slot))
    reg_ord = torch.cumsum(marks[:g_max], 0, dtype=_I32) - 1
    nonempty = static_nonzero(nblk > 0, nreg, nreg)
    g = torch.arange(g_max, dtype=_I32, device=dev)
    valid = g < total
    picked = nonempty[torch.clamp(reg_ord, 0, nreg - 1).to(torch.int64)]
    reg = torch.clamp(torch.where(valid, picked, nreg - 1), 0,
                      nreg - 1).to(torch.int64)
    blk_in_reg = torch.where(valid, g - blk_excl[reg], 0)
    offset = torch.where(valid, rbase[reg] + blk_in_reg * kpb, 0)
    count = torch.where(valid,
                        torch.clamp(rsize[reg] - blk_in_reg * kpb, 0, kpb), 0)
    seg = torch.where(valid & (ract[reg] == 1), rseg[reg], a_max)
    active = torch.where(valid, ract[reg], 0)
    reset = torch.where(valid, (blk_in_reg == 0).to(_I32), 1)
    blocks = RegionBlocks(seg=seg.to(_I32), offset=offset.to(_I32),
                          reset=reset.to(_I32), count=count.to(_I32),
                          active=active.to(_I32))
    if batch is None:
        return blocks
    return pack_region_blocks(blocks, batch, seg_pad=a_max)


_MERGE_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]


def merge_rows(hist: torch.Tensor, local_threshold: int, merge_threshold: int):
    """Apply R3 to each active bucket's sub-bucket size row.

    Returns (group_start, group_done): (A, r) bools — whether sub-bucket v
    starts a new (merged) bucket, and whether that bucket is finished.
    """
    if _build.on_cpu(hist):
        out = ref.merge_rows_ref(hist, local_threshold, merge_threshold)
        if _build.RECORDER is not None and hist.shape[0]:
            _build.RECORDER.launch("merge_rows", plain=True, reads=(hist,),
                                   writes=out)
        return out
    hist = hist.to(_I32).contiguous()
    _build.check_cuda(hist)
    gstart = torch.empty(hist.shape, dtype=torch.bool, device=hist.device)
    gdone = torch.empty_like(gstart)
    rows, r = hist.shape
    if rows:
        fn = _build.function("merge_rows", "merge_rows_launch", _MERGE_ARGS)
        with torch.cuda.device(hist.device):
            rc = fn(_build.ptr(hist), rows, r, local_threshold,
                    merge_threshold, _build.ptr(gstart), _build.ptr(gdone),
                    _build.stream_handle(hist.device))
        _build.check("merge_rows", rc)
        _build.COUNTS["merge_rows"] += 1
        if _build.RECORDER is not None:
            _build.RECORDER.launch("merge_rows", plain=False, reads=(hist,),
                                   writes=(gstart, gdone))
    return gstart, gdone


def next_active_table(hist: torch.Tensor, local_threshold: int,
                      a_max: int) -> torch.Tensor:
    """(a_max * r,) map from (active segment, digit) sub-bucket to its
    compact next-pass active-segment id (``a_max`` = done next pass)."""
    mask = (hist > local_threshold).reshape(-1)
    sid = torch.cumsum(mask, 0, dtype=_I32) - 1
    return torch.where(mask, sid, a_max).to(_I32)


#: scatter slots past the end that take dropped entries, spread so that no
#: single address takes every dropped write (a hot spot on the card)
_DUMP = 1024


def _or_dump(idx: torch.Tensor, keep: torch.Tensor, end: int) -> torch.Tensor:
    """``idx`` where ``keep``, else one of the ``_DUMP`` slots from ``end``."""
    spread = torch.arange(idx.numel(), dtype=_I32, device=idx.device) % _DUMP
    return torch.where(keep, idx, end + spread)


def apply_pass_bookkeeping(seg_id, done, asegs: ActiveSegments, hist,
                           gstart, gdone, dest_base):
    """Positional segment/done updates after a counting pass (the plain
    engines' dense state), from the (A, r) tables alone: merged-group
    starts (R3) become the new bucket boundaries, done groups are
    range-filled, done buckets persist."""
    n = seg_id.shape[0]
    dev = seg_id.device
    nb = torch.zeros(n + _DUMP, dtype=torch.bool, device=dev)
    nb[:n] = asegs.boundary & done                 # done buckets persist
    db = dest_base.reshape(-1).to(_I32)
    inside = (db >= 0) & (db < n)
    nb[_or_dump(db, gstart.reshape(-1) & inside, n)] = True
    nb[0] = True
    new_seg = torch.cumsum(nb[:n], 0, dtype=_I32) - 1

    # done ranges via +1/-1 marks and a prefix sum (empty groups cancel)
    h = hist.reshape(-1).to(_I32)
    gd = gdone.reshape(-1) & (h > 0)
    de = db + h
    dm = torch.zeros(n + 1 + _DUMP, dtype=_I32, device=dev)
    ones = torch.ones_like(db)
    dm.index_add_(0, _or_dump(db, gd & (db >= 0) & (db <= n), n + 1), ones)
    dm.index_add_(0, _or_dump(de, gd & (de >= 0) & (de <= n), n + 1), -ones)
    new_done = done | (torch.cumsum(dm[:n], 0, dtype=_I32) > 0)
    return new_seg, new_done


def bincount(ids: torch.Tensor, length: int) -> torch.Tensor:
    """(length,) int32 counts of ``ids`` as ``jnp.bincount(ids,
    length=length)`` takes them: a negative id counts in bin 0, an id past
    the end is dropped."""
    slot = torch.clamp(ids.to(torch.int64), 0, length)
    out = torch.zeros(length + 1, dtype=_I32, device=ids.device)
    out.index_add_(0, slot, torch.ones_like(slot, dtype=_I32))
    return out[:length]


def one_segment_passes(ukeys, leaves, d: int, k: int, kpb: int, lo: int,
                       nd: int):
    """The kernel engine of ``lsd_sort`` and ``single_pass_partition``: one
    prologue histogram, then ``nd`` fused passes over one always-active
    segment [0, n) (base 0, every sub-bucket to segment 0, a_max 1) at the
    LSD windows of ``lsd_digit_window``.  After each pass the written
    buffers become the current ones and its next-pass histogram the next
    base.  Returns ``(keys, leaves, hist0)``: the first (1, 2^d) base."""
    n = ukeys.shape[0]
    dev = ukeys.device
    r = 1 << d
    (ck, cv), (ak, av) = fused.make_ping_pong(ukeys, leaves, kpb)
    blocks = make_region_blocks(
        torch.zeros(1, dtype=_I32, device=dev),
        torch.full((1,), n, dtype=_I32, device=dev), n, kpb,
        max_region_blocks(n, kpb, 1))
    nsid = torch.zeros(r, dtype=_I32, device=dev)    # every digit: segment 0
    w0 = min(d, max(k - lo, 1))
    hist0 = seg_hist = fused.initial_histogram(ck, n, lo, w0, r, 1, kpb)
    # the passes are unrolled, as in the reference: a loop that only
    # labels the launches of the recorder
    loop = (None if _build.RECORDER is None else
            _build.RECORDER.loop("lsd.passes", unrolled=True))
    for p in range(nd):
        if loop is not None:
            loop.step()
        base_excl = torch.cumsum(seg_hist, 1, dtype=_I32) - seg_hist
        nk, nv, hist_next = fused.fused_counting_pass(
            ck, cv, ak, av, lsd_digit_window(p, k, d, lo=lo), *blocks,
            base_excl, nsid, kpb=kpb, r=r, a_max=1, n=n)
        ak, av, ck, cv = ck, cv, nk, nv
        seg_hist = hist_next.reshape(1, r)
    if loop is not None:
        loop.close()
    return ck[:n], [v[:n] for v in cv], hist0


def single_pass_partition(ids: torch.Tensor, num_buckets: int,
                          engine: str = None, kpb: int = 1024):
    """One stable counting pass over flat bucket ids: ``(dest, perm,
    counts)``, int32 — element i goes to slot ``dest[i]``, slot j holds
    element ``perm[j]``, and ``counts`` has ``num_buckets`` entries.

    The primitive under ``segmented.counting_partition`` (MoE dispatch,
    length bucketing, shard partitioning).  ``engine="kernel"`` (``auto`` on
    CUDA) runs the prologue histogram over ``bit_length(num_buckets - 1)``
    bits and ONE fused launch over a single always-active segment, the
    positions riding along as the value leaf; on CUDA a kernel that fails
    to build or launch raises.  ``argsort`` / ``scan`` (and ``m == 0``) use
    ``ranks.stable_partition_dest``.
    """
    engine = resolve_engine(engine, ids.device)
    m = ids.shape[0]
    ids = ids.to(_I32)
    if m == 0 or engine != "kernel":
        rank_engine = engine if engine != "kernel" else "argsort"
        dest = stable_partition_dest(ids, num_buckets,
                                     engine=rank_engine).to(_I32)
        return dest, invert_permutation(dest), bincount(ids, num_buckets)

    width = max(1, (num_buckets - 1).bit_length())
    kpb = max(8, min(kpb, 1 << (m - 1).bit_length()))   # one block if m small
    iota = torch.arange(m, dtype=_I32, device=ids.device)
    _, (perm,), hist0 = one_segment_passes(ids, (iota,), width, width, kpb,
                                           0, 1)
    return invert_permutation(perm), perm, hist0[0, :num_buckets]


# --- contract declaration (verified by repro_torch.analysis; see
# analysis/contracts)
# One standalone partition = prologue histogram + ONE fused launch; the iota
# permutation payload rides as one value leaf (vals = 1), so the pass moves
# (2·1+1) key sweeps + 2 payload sweeps over the padded buffer.
ANALYSIS_CONTRACT = {
    "entry": "repro_torch.core.plan.single_pass_partition",
    "census": {
        "launch_total": "2",
        "while_body_launches": "[]",
        "fused_grid": "ceil_div(g_max, B)",
    },
    "sort_free": True,
    "donation": {"_fused_pass_kernel": "1 + vals"},
    "transfer": {
        "sweep_kernels": ["_hist_kernel", "_fused_pass_kernel"],
        "bytes": "(2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb",
    },
}
