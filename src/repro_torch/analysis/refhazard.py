"""Descriptor-table and write hazards: the port's ``refhazard``.

The fused and merge kernels write their outputs through scatters whose
destinations come from descriptor tables, and read their inputs in blocks
at table offsets.  For the §4.3 "one read + one write sweep" accounting to
be true and safe:

  1. the descriptor tables drive disjoint, exactly-covering index ranges
     and every block load stays inside the padded buffer — interval
     analysis on table instances built by the port's own planners
     (:func:`check_fused_tables`, :func:`check_merge_tables`, the
     reference's checks on the same tables);
  2. every output lane is written exactly once — the port's form of the
     reference's kernel-body checks (a CUDA body cannot be read as a
     jaxpr can): the launch is replayed with an ``arange`` value leaf, and
     the leaf must come back as a permutation of ``[0, m)``, m the live
     lanes of the tables (:func:`replay_written_once`, run by the launch
     recorder with ``hazard=True``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _interval_findings(intervals, total: int, label: str,
                       cover: bool = True) -> List[str]:
    """Disjointness + exact-coverage findings for [start, end) intervals."""
    findings: List[str] = []
    ivs = sorted((int(a), int(b)) for a, b in intervals if b > a)
    covered = 0
    prev = (None, 0)
    for a, b in ivs:
        if prev[0] is not None and a < prev[1]:
            findings.append(
                f"{label}: write intervals overlap — [{prev[0]}, {prev[1]}) "
                f"and [{a}, {b})")
        covered += b - a
        prev = (a, b)
    if cover:
        lo = ivs[0][0] if ivs else 0
        hi = max((b for _, b in ivs), default=0)
        if not findings and (lo != 0 or hi != total or covered != total):
            findings.append(
                f"{label}: intervals cover [{lo}, {hi}) with {covered} "
                f"elements, expected exactly [0, {total})")
    return findings


def check_fused_tables(blocks, n: int, kpb: int, n_pad: int) -> List[str]:
    """Interval analysis on a fused-launch descriptor table instance.

    ``blocks`` is a ``plan.RegionBlocks`` of tensors or arrays (flat or
    packed); rows flatten in descriptor order.  Proves: (a) each row's block load ``[off, off + kpb)``
    fits the padded buffer, (b) rows group into regions at ``reset`` flags
    whose write intervals ``[first_offset, first_offset + Σcount)`` are
    pairwise disjoint and tile ``[0, n)`` exactly — the exactly-once scatter
    coverage of one fused pass.
    """
    seg, off, reset, cnt, act = (_np(t).reshape(-1)
                                 for t in (blocks.seg, blocks.offset,
                                           blocks.reset, blocks.count,
                                           blocks.active))
    findings: List[str] = []
    for g in range(off.shape[0]):
        if int(off[g]) < 0 or int(off[g]) + kpb > n_pad:
            findings.append(
                f"fused tables: row {g} loads [{int(off[g])}, "
                f"{int(off[g]) + kpb}) outside padded buffer [0, {n_pad})")
    regions = []
    cur = None
    for g in range(off.shape[0]):
        if int(reset[g]) == 1:
            if cur is not None:
                regions.append(cur)
            cur = [int(off[g]), int(off[g])]
        if cur is None:
            findings.append(f"fused tables: row {g} precedes any reset row")
            cur = [int(off[g]), int(off[g])]
        c = int(cnt[g])
        if c:
            if int(off[g]) != cur[1]:
                findings.append(
                    f"fused tables: row {g} offset {int(off[g])} breaks its "
                    f"region's contiguity (expected {cur[1]})")
            cur[1] = int(off[g]) + c
    if cur is not None:
        regions.append(cur)
    findings.extend(_interval_findings(regions, n, "fused tables"))
    return findings


def check_merge_tables(out_off, out_cnt, win_start, win_take, *, kway: int,
                       tpb: int, n: int, buf_len: int) -> List[str]:
    """Interval analysis on one merge round's tile descriptor tables.

    Proves the per-tile write intervals ``[out_off, out_off + out_cnt)``
    are disjoint and tile ``[0, n)`` exactly, every window load
    ``[win_start, win_start + tpb)`` fits the run buffer, and each tile's
    live window lanes sum to its live output count (no element dropped or
    merged twice across tiles).
    """
    oo = _np(out_off).reshape(-1)
    oc = _np(out_cnt).reshape(-1)
    ws = _np(win_start).reshape(-1, kway) \
        if _np(win_start).size else np.zeros((0, kway), np.int32)
    wt = _np(win_take).reshape(-1, kway) \
        if _np(win_take).size else np.zeros((0, kway), np.int32)
    findings = _interval_findings(
        zip(oo.tolist(), (oo + oc).tolist()), n, "merge tables")
    for g in range(ws.shape[0]):
        for r in range(kway):
            s = int(ws[g, r])
            if s < 0 or s + tpb > buf_len:
                findings.append(
                    f"merge tables: tile {g} run {r} loads [{s}, {s + tpb}) "
                    f"outside buffer [0, {buf_len})")
            t = int(wt[g, r])
            if t < 0 or t > tpb:
                findings.append(
                    f"merge tables: tile {g} run {r} take {t} outside "
                    f"[0, {tpb}]")
        if g < oc.shape[0] and int(wt[g].sum()) != int(oc[g]):
            findings.append(
                f"merge tables: tile {g} window takes sum to "
                f"{int(wt[g].sum())} but writes {int(oc[g])} lanes")
    return findings


def permutation_findings(leaf: torch.Tensor, m: int, label: str) -> List[str]:
    """Whether ``leaf[:m]`` is a permutation of ``[0, m)``."""
    got = leaf[:m].to(torch.int64)
    bad = int(((got < 0) | (got >= m)).sum())
    counts = torch.bincount(got.clamp(0, max(m - 1, 0)), minlength=m)
    twice = int((counts > 1).sum())
    never = int((counts == 0).sum())
    if bad or twice or never:
        return [f"{label}: the arange leaf came back with {bad} lane(s) "
                f"unwritten or out of range, {twice} source lane(s) written "
                f"more than once and {never} never — not a permutation of "
                f"[0, {m})"]
    return []


def replay_written_once(name: str, call) -> List[str]:
    """Replay one fused or merge launch with an ``arange`` value leaf into
    fresh alternate buffers (the real alternates keep the launch's result)
    and check that every lane was written exactly once."""
    fn, args, kwargs = call
    src_keys, _, alt_keys = args[:3]
    leaf = torch.arange(src_keys.shape[0], dtype=torch.int32,
                        device=src_keys.device)
    alt_k = torch.empty_like(alt_keys).fill_(-1)
    alt_leaf = torch.full_like(leaf, -1)
    out = fn(src_keys, (leaf,), alt_k, (alt_leaf,), *args[4:], **kwargs)
    if name == "_fused_pass_kernel":
        m = int(kwargs["n"])
    else:
        m = int(args[5].to(torch.int64).sum())      # the live output lanes
    return permutation_findings(out[1][0], m, name)
