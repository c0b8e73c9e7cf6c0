"""Merge-path k-way merge: port of ``repro.kernels.merge``.

The out-of-core sort (``core.outofcore``) merges sorted runs in rounds; a
round fuses groups of up to K adjacent runs into one run each with ONE
launch of the merge kernel.  This module holds both halves of that merge:

  * the partition math.  ``merge_path_partition`` cuts every group's output
    into tiles of ``tpb`` keys and finds, per tile boundary, the co-ranks
    of the K runs (the k-dimensional merge path, ties broken by (key, run,
    position)) with bitwise binary searches on the runs' device
    (``_coranks``); the tables equal the reference's entry for entry.  The
    host-spill path's numpy copies (``host_coranks``,
    ``spill_group_plan``) are the reference's, unchanged: host runs are
    numpy arrays in the reference's unsigned ordered bits;
  * ``kway_merge_round``, the wrapper of ``csrc/merge.cu`` (one CTA per
    output tile: a merge tree in shared memory and write-combined stores,
    or on short tiles a per-lane rank and scatter; see the source note).
    On a CPU tensor it runs the plain version ``ref.kway_merge_round_ref``.

Device keys are the port's carrier (``core.bijection``): a signed dtype
holding the unsigned ordered bits, so every order test here compares
``sortable(carrier)`` (top bit flipped).  The alternate buffers are written
in place and returned, which takes the place of the reference's donation.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.bijection import sortable
from repro_torch.kernels import _build, ref

#: the opt-in shared memory one CTA may use on Hopper
SMEM_LIMIT = 232448
#: value leaves one launch carries (the C side's pointer table)
MAX_LEAVES = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]
_PROBE_ARGS = _ARGS[:-1] + [_I, _P]
#: the kernels ``_kway_merge_probe`` can force (csrc/merge.cu: force)
_PROBE = {"small": 1, "tree": 2}


def merge_groups(lens, kway: int):
    """Group adjacent runs for one round: [[len, ...], ...] of <= kway runs."""
    lens = list(lens)
    return [lens[i:i + kway] for i in range(0, len(lens), kway)]


def num_merge_rounds(num_runs: int, kway: int) -> int:
    """⌈log_kway(num_runs)⌉ — rounds until a single run remains."""
    rounds = 0
    while num_runs > 1:
        num_runs = -(-num_runs // kway)
        rounds += 1
    return rounds


def _coranks(runs, diags) -> torch.Tensor:
    """Diagonal partition of K sorted carrier runs at every diagonal.

    ``runs`` is a list of 1-D carrier tensors on one device, each sorted in
    key order (no padding: every search is bounded by the run's own
    length); ``diags`` the merged prefix lengths m.  Returns (D, K) int64
    co-ranks c with ``sum(c[i]) == m[i]`` and the selected elements exactly
    the m smallest under (key, run, position) order.

    The m-th order statistic's key v* is built bit by bit, MSB down, in the
    carrier's bit pattern (bitwise OR only, so no signed overflow); every
    search runs in the ``sortable`` domain, where signed order is the
    reference's unsigned order.  ``count(cand, "left")`` is the reference's
    ``count(cand - 1, "right")`` without the unsigned wrap.
    """
    dev = runs[0].device
    dt = runs[0].dtype
    bits = torch.iinfo(dt).bits
    m = torch.as_tensor(np.asarray(diags, np.int64), device=dev)
    srt = [sortable(r.contiguous()) for r in runs]

    def count(v, side):                         # (D,) bound -> (D, K)
        q = sortable(v)
        return torch.stack([torch.searchsorted(s, q, side=side) for s in srt],
                           dim=1)

    v = torch.zeros(m.shape, dtype=dt, device=dev)
    for b in reversed(range(bits)):
        # the top bit is the carrier's minimum value (1 << 63 overflows int64)
        bit = torch.iinfo(dt).min if b == bits - 1 else 1 << b
        cand = v | bit
        below = count(cand, "left").sum(dim=1)
        v = torch.where(below < m, cand, v)

    lb = count(v, "left")                       # keys <  v* per run
    ties = count(v, "right") - lb               # keys == v* per run
    rem = (m - lb.sum(dim=1))[:, None]
    excl = torch.cumsum(ties, dim=1) - ties
    return lb + torch.minimum(torch.clamp(rem - excl, min=0), ties)


def merge_path_partition(keys: torch.Tensor, lens, kway: int, tpb: int):
    """Tile descriptor tables for one merge round over ``keys``.

    ``keys`` is the flat carrier run buffer (sorted runs back to back,
    padding beyond ``sum(lens)``), ``lens`` the per-run lengths.  Returns
    int32 tensors on the keys' device ``(out_off, out_cnt, win_start,
    win_take)``: per output tile its absolute offset and live count (G,),
    and the flattened (G * kway,) per-run window start and live lane
    count.  Runs beyond a group's width get ``start = n``, ``take = 0``;
    single-run groups are a copy-through partition.
    """
    dev = keys.device
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(offs[-1])
    out_off, out_cnt, ws_parts, wt_parts = [], [], [], []
    g0 = 0
    for glens in merge_groups(lens, kway):
        k = len(glens)
        gbase = int(offs[g0])
        glen = int(sum(glens))
        ntiles = max(1, -(-glen // tpb))
        diags = np.minimum(np.arange(ntiles + 1, dtype=np.int64) * tpb, glen)
        if k == 1:
            cor = torch.as_tensor(diags[:, None], device=dev)
        else:
            cor = _coranks([keys[int(offs[g0 + r]):int(offs[g0 + r + 1])]
                            for r in range(k)], diags)
        run_base = torch.as_tensor(offs[g0:g0 + k], device=dev)
        start = cor[:-1] + run_base[None, :]
        take = cor[1:] - cor[:-1]
        if kway > k:
            start = torch.cat([start, start.new_full((ntiles, kway - k), n)],
                              dim=1)
            take = torch.cat([take, take.new_zeros((ntiles, kway - k))], dim=1)
        ws_parts.append(start)
        wt_parts.append(take)
        out_off.append(gbase + diags[:-1])
        out_cnt.append(diags[1:] - diags[:-1])
        g0 += k

    def table(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.int32),
                               device=dev)

    return (table(out_off), table(out_cnt),
            torch.cat(ws_parts).reshape(-1).to(torch.int32),
            torch.cat(wt_parts).reshape(-1).to(torch.int32))


# --------- host-side partition math (the out-of-core spill path) ------------

def host_coranks(runs, diags) -> np.ndarray:
    """NumPy mirror of :func:`_coranks` over host-resident runs.

    ``runs`` is a list of 1-D sorted unsigned numpy arrays; ``diags`` the
    merged prefix lengths m.  Returns (D, K) int64 co-ranks with
    ``sum(c[i]) == m[i]`` and the selected elements exactly the m smallest
    under (key, run, position) order.  Each diagonal costs
    O(bits · K · log L) probed elements.
    """
    dt = np.dtype(runs[0].dtype)
    bits = np.iinfo(dt).bits
    m = np.asarray(diags, np.int64)

    def count(vals, side):                      # (D,) bounds -> (D, K)
        return np.stack([np.searchsorted(r, vals, side=side)
                         for r in runs], axis=1).astype(np.int64)

    v = np.zeros(m.shape, dt)
    for b in reversed(range(bits)):
        cand = v | np.asarray(1 << b, dt)
        below = count(cand, "left").sum(axis=1)
        v = np.where(below < m, cand, v)

    lb = count(v, "left")                       # keys <  v* per run
    ties = count(v, "right") - lb               # keys == v* per run
    rem = (m - lb.sum(axis=1))[:, None]
    excl = np.cumsum(ties, axis=1) - ties
    return lb + np.clip(rem - excl, 0, ties)


class SpillStrip(NamedTuple):
    """One slab-sized strip of a merge group's output (host-spill path).

    ``win_lo``/``win_len`` select each run's window feeding the strip
    (``sum(win_len) == out_len``); the windows pack back to back into a
    slab and ``tables`` are the slab-local descriptors for
    :func:`kway_merge_round` (``n = slab_elems``), zero-count-padded to the
    slab's full ``G = slab_elems // tile`` grid.
    """
    out_lo: int                 # group-relative output offset of the strip
    out_len: int                # live output elements (== sum(win_len))
    win_lo: Tuple[int, ...]     # per-run window start within each run
    win_len: Tuple[int, ...]    # per-run window length
    tables: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def spill_group_plan(runs, kway: int, tile: int, slab_elems: int):
    """Cut one merge group of host-resident runs into slab-sized strips.

    ``runs`` is a list of <= ``kway`` sorted unsigned numpy runs;
    ``slab_elems`` (a multiple of ``tile``) bounds each strip's output.  The
    group's merge path is solved once at tile granularity by
    :func:`host_coranks`, then sliced into strips of ``slab_elems // tile``
    whole output tiles, so strips tile the group's output exactly once and
    the (key, run, position) tie order holds across strip boundaries.
    """
    if slab_elems < tile or slab_elems % tile:
        raise ValueError("slab_elems must be a positive multiple of tile")
    k = len(runs)
    glen = sum(int(r.shape[0]) for r in runs)
    ntiles = max(1, -(-glen // tile))
    diags = np.minimum(np.arange(ntiles + 1, dtype=np.int64) * tile, glen)
    cor = diags[:, None] if k == 1 else host_coranks(runs, diags)
    g = slab_elems // tile
    strips = []
    for t0 in range(0, ntiles, g):
        t1 = min(t0 + g, ntiles)
        nt = t1 - t0
        win_lo = tuple(int(cor[t0, r]) for r in range(k))
        win_len = tuple(int(cor[t1, r] - cor[t0, r]) for r in range(k))
        seg = np.concatenate([[0], np.cumsum(win_len)])
        # dead tiles / runs point their window at the slab's pad region
        # (start = slab_elems, take = 0) exactly like merge_path_partition
        out_off = np.zeros(g, np.int32)
        out_cnt = np.zeros(g, np.int32)
        ws = np.full((g, kway), slab_elems, np.int32)
        wt = np.zeros((g, kway), np.int32)
        out_off[:nt] = (diags[t0:t1] - diags[t0]).astype(np.int32)
        out_cnt[:nt] = (diags[t0 + 1:t1 + 1] - diags[t0:t1]).astype(np.int32)
        for r in range(k):
            ws[:nt, r] = (seg[r] + cor[t0:t1, r] - cor[t0, r]).astype(np.int32)
            wt[:nt, r] = (cor[t0 + 1:t1 + 1, r] -
                          cor[t0:t1, r]).astype(np.int32)
        strips.append(SpillStrip(int(diags[t0]), int(diags[t1] - diags[t0]),
                                 win_lo, win_len,
                                 (out_off, out_cnt, ws.reshape(-1),
                                  wt.reshape(-1))))
    return strips


# --------- the merge kernel --------------------------------------------------

def smem_bytes(kway: int, tpb: int, key_bytes: int) -> int:
    """Shared memory one CTA needs (``csrc/merge.cu``: windows_smem): the
    per-run start / take / offset tables and the K staged windows of
    ``tpb`` keys, each rounded up to 16 bytes.  The kernel adds the tree's
    output table only where it fits next to them."""
    return -(-4 * (3 * kway + 1) // 16) * 16 + -(-kway * tpb * key_bytes //
                                                  16) * 16


def _check_launch(src_keys, src_vals, alt_keys, alt_vals, tables, kway, tpb):
    kb = src_keys.element_size()
    need = smem_bytes(kway, tpb, kb)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"kway * tpb * key bytes = {kway} * {tpb} * {kb} = "
            f"{kway * tpb * kb} bytes of staged windows ({need} with the "
            f"tables) exceed the {SMEM_LIMIT} bytes of shared memory a CTA "
            f"can hold")
    if len(src_vals) > MAX_LEAVES or len(alt_vals) != len(src_vals):
        raise ValueError(f"at most {MAX_LEAVES} value leaves per launch, "
                         f"one alternate buffer each")
    for v in (src_keys, alt_keys, *src_vals, *alt_vals):
        if v.dim() != 1 or v.element_size() not in (1, 2, 4, 8):
            raise ValueError("keys and value leaves must be 1-D with 1, 2, 4 "
                             "or 8-byte elements")
    g = tables[0].numel()
    if tables[1].numel() != g or any(t.numel() != g * kway
                                     for t in tables[2:]):
        raise ValueError("descriptor tables must be (G,), (G,), (G*kway,), "
                         "(G*kway,)")
    _build.check_cuda(src_keys, alt_keys, *src_vals, *alt_vals, *tables)


def kway_merge_round(src_keys, src_vals, alt_keys, alt_vals, out_off,
                     out_cnt, win_start, win_take, *, kway: int, tpb: int,
                     n: int, rank: str = "searchsorted"):
    """One k-way merge round over all groups in ONE launch.

    ``src_keys``/``src_vals`` hold the sorted runs back to back in a
    ``pad_length``-sized buffer (``src_vals`` a tuple of 1-D leaves);
    ``alt_*`` are the alternate buffers, written in place.  The tables come
    from :func:`merge_path_partition` (device-resident rounds) or
    :func:`spill_group_plan` (slab strips; there ``n`` is the slab
    capacity).  Returns ``(alt_keys, alt_vals)`` with every group's runs
    merged over ``[0, n)``; slot ``n`` and the padding after it are
    unspecified.

    ``rank`` is the reference's tile-rank mode (``"searchsorted"`` or the
    ``"counting"`` oracle).  Both compute the same function: the plain
    version follows the mode on a CPU tensor, and on a CUDA tensor both
    launch the kernel.
    """
    if rank not in ("searchsorted", "counting"):
        raise ValueError(f"unknown tile rank mode {rank!r}")
    cpu = _build.on_cpu(src_keys)
    if cpu:
        out = ref.kway_merge_round_ref(
            src_keys, tuple(src_vals), alt_keys, tuple(alt_vals), out_off,
            out_cnt, win_start, win_take, kway=kway, tpb=tpb, n=n, rank=rank)
    else:
        out = _launch(src_keys, src_vals, alt_keys, alt_vals,
                      (out_off, out_cnt, win_start, win_take), kway, tpb, None)
    if _build.RECORDER is not None and out_off.numel():
        _build.RECORDER.launch(
            "_kway_merge_kernel", plain=cpu, reads=(src_keys, *src_vals),
            writes=(out[0], *out[1]), alts=(alt_keys, *alt_vals),
            tables=tuple(out_off.shape),
            call=(kway_merge_round,
                  (src_keys, src_vals, alt_keys, alt_vals, out_off, out_cnt,
                   win_start, win_take),
                  dict(kway=kway, tpb=tpb, n=n, rank=rank)))
    return out


def _kway_merge_probe(src_keys, src_vals, alt_keys, alt_vals, out_off,
                      out_cnt, win_start, win_take, *, kway: int, tpb: int,
                      kernel: str):
    """The round of :func:`kway_merge_round` on CUDA tensors with one of the
    two kernels forced whatever the tile (``"small"``: the per-lane rank
    and scatter; ``"tree"``: the merge tree, refused where the tree cannot
    take the tile).  For timing only: ``scripts/torch_merge_breakdown.py``.
    """
    return _launch(src_keys, src_vals, alt_keys, alt_vals,
                   (out_off, out_cnt, win_start, win_take), kway, tpb,
                   _PROBE[kernel])


def _launch(src_keys, src_vals, alt_keys, alt_vals, tables, kway, tpb,
            force):
    src_vals, alt_vals = tuple(src_vals), tuple(alt_vals)
    tables = tuple(t.reshape(-1).to(torch.int32).contiguous()
                   for t in tables)
    _check_launch(src_keys, src_vals, alt_keys, alt_vals, tables, kway, tpb)
    g = tables[0].numel()
    if g == 0:
        return alt_keys, alt_vals
    nv = len(src_vals)
    val_src = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in src_vals])
    val_dst = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in alt_vals])
    val_bytes = (ctypes.c_int * max(nv, 1))(*[v.element_size()
                                              for v in src_vals])
    dev = src_keys.device
    args = [_build.ptr(src_keys), _build.ptr(alt_keys),
            src_keys.element_size(), val_src, val_dst, val_bytes, nv,
            *[_build.ptr(t) for t in tables], g, kway, tpb]
    if force is None:
        fn = _build.function("merge", "kway_merge_launch", _ARGS)
    else:
        fn = _build.function("merge", "kway_merge_probe", _PROBE_ARGS)
        args.append(force)
    with torch.cuda.device(dev):
        rc = fn(*args, _build.stream_handle(dev))
    _build.check("merge", rc)
    _build.COUNTS["merge"] += 1
    return alt_keys, alt_vals
