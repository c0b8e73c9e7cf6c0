"""The hybrid MSD radix sort (paper §4): port of ``repro.core.hybrid``.

The algorithm is the reference's, step for step:

  * counting passes from the most significant d-bit digit partition every
    active bucket (size > ∂̂) into up to r = 2^d sub-buckets (R2), runs of
    tiny sub-buckets merge while their total stays below ∂ (R3), buckets at
    or below ∂̂ become done and are finished by one local sort (R1);
  * the loop exits when no active bucket remains or the digits run out;
  * every derived table comes from ``core.plan`` at the reference's static
    sizes.  The plain-torch engines keep bucket state dense per key
    (segment ids + done flags); the kernel engine keeps it as a
    ``plan.SegmentTable`` of at most s_max (start, size, done) rows, so no
    step of its plan reads or writes per key.

Three engines give byte-identical results:

  * ``kernel``  — one fused launch per executed pass on ping-pong buffers
    (``kernels.fused``), the prologue histogram (``kernels.histogram``) and
    one stable local-sort launch per size class (``kernels.bitonic``).  On a
    CUDA tensor these are the hand-written CUDA kernels; on a CPU tensor the
    kernels' plain versions;
  * ``argsort`` — stable ``torch.sort`` partitions; the CPU default;
  * ``scan``    — the O(n) chunked-rank partitions of ``core.ranks``.

The entropy-adaptive schedule is the reference's: a live-bit window
narrows the passes (one OR- and one AND-reduce on the device, two scalars
read back), single-digit passes are elided using the lookahead histogram,
and ``compress=True`` sorts the bit-packed live columns.

The pass loop runs on the host.  Each pass ends in one device-to-host read
(the next pass's exit test, together with the adaptive skip test on the
kernel engine; the plain-torch engines read the skip test separately),
and one read before the loop tests the first.  Every device-to-host read
of a sort (these, the live-bit window or the compression plan, the
finishing test, the stats) is counted in
``kernels._build.COUNTS["host_reads"]`` and held, with the reductions it
reads, by a ``hybrid_sort.read`` span.

While a profiler records, a sort logs its spans in ``core.spans.LOG``:
``hybrid_sort`` (``n``, ``key_bits``, ``value_bytes``, ``engine``) holds
``hybrid_sort.prologue``, the read before the loop, one
``hybrid_sort.pass`` per pass the loop enters (``p``, ``executed``,
``active_records``: the records of its active buckets; on the kernel
engine ``segments``: the table's buckets after the pass), the finishing
read, ``hybrid_sort.local_sort`` (``records``: the records of done
buckets) and ``hybrid_sort.epilogue``; a pass holds ``hybrid_sort.plan``,
``hybrid_sort.scatter`` unless elided, and the read that ends it.  The
counts are tallies of the plan's own tables (``ActiveSegments.size``, the
segment table, the local sort's bucket sizes): one reduction each,
enqueued only while a profiler records.  With none recording the sort runs
no op and makes no read for its spans.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bijection, interop, model, plan, spans
from repro_torch.core.ranks import resolve_engine, stable_partition_dest
from repro_torch.kernels import _build, fused
from repro_torch.kernels.ops import local_sort_class_plan, segmented_local_sort

_I32 = torch.int32
_MOVABLE = {torch.uint16: torch.int16, torch.uint32: torch.int32,
            torch.uint64: torch.int64}


class SortStats(NamedTuple):
    counting_passes: int       # executed counting passes
    used_local_sort: bool      # did the final local sort run
    num_segments: int          # segments at exit (I3 bound check)
    max_segment: int           # largest segment at exit
    elided_passes: int = 0     # adaptive: passes advanced with no launch


def _host_read():
    """Count one device-to-host read; the returned span holds it."""
    _build.COUNTS["host_reads"] += 1
    return spans.span("hybrid_sort.read")


def _read(t: torch.Tensor) -> list:
    """One counted device-to-host read."""
    with _host_read():
        return t.tolist()


def live_bit_window(carrier: torch.Tensor) -> tuple:
    """Live-bit window [lo, hi) of the ordered-bits carrier as Python ints;
    ``(0, 0)`` when every key is equal or there are none."""
    if carrier.numel() == 0:
        return 0, 0
    with _host_read():
        orv, andv = bijection.bit_summary(carrier)
    live = orv ^ andv
    if not live:
        return 0, 0
    return (live & -live).bit_length() - 1, live.bit_length()


def _single_digit(hist: torch.Tensor) -> torch.Tensor:
    """Device bool: every active segment has at most one occupied digit."""
    return torch.all(torch.sum(hist > 0, dim=1) <= 1)


def _skip_predicate(single: bool, nxt_valid: bool, p: int, nd: int) -> bool:
    """The shared elision predicate (identical across all engines): a pass
    whose segments each hold one digit is the identity; it is skipped when
    the next histogram is in hand or it is the last pass."""
    return single and (nxt_valid or p >= nd - 1)


def _group_tables(asegs, hist, cfg):
    """``(gstart, gdone, dest_base)`` of a pass: R3's merged groups and the
    first destination of each (active segment, digit) sub-bucket."""
    gstart, gdone = plan.merge_rows(hist, cfg.local_threshold,
                                    cfg.merge_threshold)
    excl = torch.cumsum(hist, 1, dtype=_I32) - hist
    return gstart, gdone, asegs.base[:, None] + excl         # (a_max, r)


def _counting_pass_torch(ukeys, leaves, seg_id, done, p, *, k, d, lo, a_max,
                         cfg, engine, skip_fn):
    """One counting pass, plain-torch engines (``argsort`` / ``scan``).
    Returns the new keys, leaves, bucket state and whether it executed."""
    n = ukeys.shape[0]
    r = 1 << d
    with spans.span("hybrid_sort.plan"):
        active = ~done
        asegs = plan.active_segments(seg_id, done, a_max)
        asid = asegs.index
        digit = plan.digit_at(ukeys, p, k, d, lo=lo)
        comp = torch.where(active, asid * r + digit, a_max * r)
        hist = torch.zeros(a_max * r + 1, dtype=_I32, device=ukeys.device)
        hist.index_add_(0, comp, torch.ones_like(comp))
        hist = hist[:a_max * r].reshape(a_max, r)
        new_seg, new_done = plan.apply_pass_bookkeeping(
            seg_id, done, asegs, hist, *_group_tables(asegs, hist, cfg))

    executed = not skip_fn(hist)
    spans.note(executed=executed)
    spans.tally("active_records", asegs.size)
    if executed:
        with spans.span("hybrid_sort.scatter"):
            dest0 = stable_partition_dest(comp, a_max * r + 1, engine=engine)
            done_rank = stable_partition_dest(done.to(_I32), 2, engine=engine)
            slots = torch.empty(n, dtype=_I32, device=ukeys.device)
            slots[done_rank] = torch.arange(n, dtype=_I32,
                                            device=ukeys.device)
            dest = slots[dest0]       # active slots ascending, then done
            new_keys = torch.empty_like(ukeys)
            new_keys[dest] = ukeys
            new_leaves = []
            for v in leaves:
                nv = torch.empty_like(v)
                nv[dest] = v
                new_leaves.append(nv)
            ukeys, leaves = new_keys, new_leaves
    return ukeys, leaves, new_seg, new_done, executed


def _local_sort(ukeys, leaves, seg_id, done):
    """Finish done buckets: order by (bucket, masked key, position).

    Only done buckets sort (the masked key keeps the rest in place), so
    under ``max_passes`` truncation unfinished buckets stay as partitioned.
    """
    spans.tally("records", done)
    masked = torch.where(done, ukeys, torch.zeros_like(ukeys))
    o1 = torch.sort(bijection.sortable(masked), stable=True).indices
    perm = o1[torch.sort(seg_id[o1], stable=True).indices]
    return ukeys[perm], [v[perm] for v in leaves]


def _local_sort_kernel(keys, leaves, table: plan.SegmentTable, *, row_len,
                       classes):
    """Kernel-engined finish: the table's done buckets sorted in place in
    ``keys`` and the value ``leaves`` (views of the ping-pong buffers), one
    launch per size class."""
    spans.tally("records", table.size, where=table.done)
    segmented_local_sort(keys, table.start, table.size, table.done, row_len,
                         classes=classes, leaves=leaves)
    return keys, leaves


def _local_row_len(n: int, cfg: model.SortConfig) -> int:
    """Local-sort row width: next power of two covering a done bucket."""
    cap = max(1, min(cfg.local_threshold, n))
    return 1 << (cap - 1).bit_length()


def local_sort_classes(n: int, cfg: model.SortConfig):
    """Static size-class plan of the kernel engine's finish: one local-sort
    launch per class at most."""
    return local_sort_class_plan(n, _local_row_len(n, cfg),
                                 model.max_total_buckets(n, cfg))


def _carrier(keys, compress: bool, narrow: bool):
    """``(carrier, cplan, lo, hi)``: the keys' ordered bits (packed to their
    live columns with ``compress``, ``cplan`` the packing) and the digit
    window [lo, hi) the passes cover (the live bits with ``narrow``)."""
    carrier = bijection.to_ordered_bits(keys)
    if compress:
        with _host_read():
            cplan = bijection.compression_plan(carrier)
        return (bijection.pack_ordered_bits(carrier, cplan), cplan, 0,
                cplan.packed_bits)
    if narrow:
        return (carrier, None, *live_bit_window(carrier))
    return carrier, None, 0, bijection.key_bits(keys.dtype)


def _hybrid_sort_bits(keys, leaves, cfg: model.SortConfig,
                      max_passes: Optional[int], engine: str, adaptive: bool,
                      compress: bool, narrow: bool):
    n = keys.shape[0]
    dev = keys.device
    d = cfg.d
    r = 1 << d
    a_max = model.max_active_buckets(n, cfg)
    p = p_exec = n_eld = 0
    nxt_valid = False

    with spans.span("hybrid_sort.prologue"):
        ukeys, cplan, lo, k = _carrier(keys, compress, narrow)
        nd = model.num_digits(max(k - lo, 0), d)
        if max_passes is not None:
            nd = min(nd, max_passes)
        if engine == "kernel":
            table = plan.segment_table(n, model.max_total_buckets(n, cfg),
                                       n <= cfg.local_threshold, dev)
            g_max = plan.max_region_blocks(n, cfg.kpb, a_max)
            (ck, cv), (ak, av) = fused.make_ping_pong(ukeys, leaves, cfg.kpb)
            w0 = min(d, max(k - lo, 1))
            hist_cur = fused.initial_histogram(ck, n, max(k - w0, 0), w0, r,
                                               a_max, cfg.kpb)
            hist_nxt = torch.zeros_like(hist_cur)
        else:
            done = torch.full((n,), n <= cfg.local_threshold,
                              dtype=torch.bool, device=dev)
            seg = torch.zeros(n, dtype=_I32, device=dev)

    if engine == "kernel":
        loop = (None if _build.RECORDER is None else
                _build.RECORDER.loop("hybrid_sort.passes"))

        def exit_test():
            with _host_read():
                return torch.stack([plan.table_any_active(table),
                                    _single_digit(hist_cur)]).tolist()

        any_active, single = exit_test() if p < nd else (False, False)
        while any_active:
            with spans.span("hybrid_sort.pass", p=p):
                if loop is not None:
                    loop.step()
                with spans.span("hybrid_sort.plan"):
                    asegs, rows = plan.table_active(table, n, a_max)
                    gstart, gdone, dest_base = _group_tables(asegs, hist_cur,
                                                             cfg)
                    new_table = plan.advance_table(table, rows, gstart, gdone,
                                                   dest_base, n)
                    nsid = plan.next_active_table(hist_cur,
                                                  cfg.local_threshold, a_max)
                    skip = adaptive and _skip_predicate(single, nxt_valid, p,
                                                        nd)
                    if skip:
                        # identity scatter: buffers stand still, the
                        # lookahead histogram becomes the current one
                        hist_cur, hist_nxt = hist_nxt, torch.zeros_like(
                            hist_nxt)
                        nxt_valid = False
                        n_eld += 1
                    else:
                        blocks = plan.make_region_blocks(
                            asegs.base, asegs.size, n, cfg.kpb, g_max)
                spans.note(executed=not skip)
                spans.tally("active_records", asegs.size)
                spans.tally("segments", new_table.size > 0)
                if not skip:
                    with spans.span("hybrid_sort.scatter"):
                        out = fused.fused_counting_pass(
                            ck, cv, ak, av, plan.digit_window(p, k, d, lo=lo),
                            *blocks, dest_base, nsid, kpb=cfg.kpb, r=r,
                            a_max=a_max, n=n, lookahead=adaptive)
                    ck, cv, ak, av = out[0], out[1], ck, cv
                    hist_cur = out[2].reshape(a_max, r)
                    if adaptive:
                        hist_nxt = out[3].reshape(a_max, r)
                        nxt_valid = p + 2 < nd
                    p_exec += 1
                table = new_table
                p += 1
                any_active, single = (exit_test() if p < nd else
                                      (False, False))
        if loop is not None:
            loop.close()
        ukeys = ck[:n]
        leaves = [v[:n] for v in cv]
        state, done = table, table.done
    else:
        def skip_fn(hist):
            if not adaptive:
                return False
            with _host_read():
                single = _single_digit(hist).tolist()
            return _skip_predicate(single, nxt_valid, p, nd)

        def exit_test():
            with _host_read():
                return (~done).any().tolist()

        any_active = exit_test() if p < nd else False
        while any_active:
            with spans.span("hybrid_sort.pass", p=p):
                ukeys, leaves, seg, done, executed = _counting_pass_torch(
                    ukeys, leaves, seg, done, p, k=k, d=d, lo=lo,
                    a_max=a_max, cfg=cfg, engine=engine, skip_fn=skip_fn)
                if adaptive:
                    nxt_valid = executed and p + 2 < nd
                p_exec += int(executed)
                n_eld += int(not executed)
                p += 1
                any_active = exit_test() if p < nd else False
        state = seg

    with _host_read():
        needs_local = bool(done.any().tolist())
    if needs_local:
        with spans.span("hybrid_sort.local_sort"):
            if engine == "kernel":
                ukeys, leaves = _local_sort_kernel(
                    ukeys, leaves, table, row_len=_local_row_len(n, cfg),
                    classes=local_sort_classes(n, cfg))
            else:
                ukeys, leaves = _local_sort(ukeys, leaves, seg, done)
    return ukeys, leaves, state, (p_exec, needs_local, n_eld), cplan


def _stats(state, n: int, counters) -> SortStats:
    """The stats of a sort from its bucket state at exit: the kernel
    engine's ``SegmentTable`` or the plain engines' segment ids."""
    p_exec, needs_local, n_eld = counters
    with _host_read():
        if isinstance(state, plan.SegmentTable):
            count = (state.size > 0).sum()
            sizes = state.size
        else:
            count = state[-1] + 1
            sizes = torch.bincount(state.to(torch.int64), minlength=n)
        last, biggest = torch.stack([count.to(torch.int64),
                                     sizes.max().to(torch.int64)]).tolist()
    return SortStats(counting_passes=p_exec, used_local_sort=needs_local,
                     num_segments=last, max_segment=biggest,
                     elided_passes=n_eld)


def hybrid_sort(keys, values: Any = None,
                cfg: Optional[model.SortConfig] = None,
                return_stats: bool = False, max_passes: Optional[int] = None,
                engine: Optional[str] = None, adaptive: Optional[bool] = None,
                compress: bool = False, device=None, narrow: bool = True):
    """Sort 1-D ``keys`` (any supported dtype) with the hybrid radix sort.

    ``keys`` and ``values`` (an optional array or pytree of arrays permuted
    alongside) may be tensors or numpy arrays.  Work runs on the keys'
    device; numpy inputs go to ``device`` — the GPU unless the caller asks
    for ``"cpu"`` — and with no GPU that raises.  Values follow the keys.

    ``engine``: ``"kernel"`` (the CUDA kernels; on a CPU tensor their plain
    versions), ``"argsort"`` or ``"scan"``; ``None`` defers to
    ``cfg.rank_engine`` and ``"auto"`` picks ``kernel`` on CUDA and
    ``argsort`` on the CPU.  On CUDA the kernel engine never falls back: a
    kernel that fails to build or launch raises.  All engines give
    byte-identical results, equal to the reference's.

    ``adaptive`` (default ``cfg.adaptive``) enables the entropy-adaptive
    schedule; ``compress=True`` sorts the bit-packed live key columns.
    ``narrow=False`` skips the adaptive schedule's static live-bit window
    and schedules the full key width (mid-sort elision stays on): the
    reference narrows concrete keys only, and its out-of-core chunk sorts
    run traced, so ``oocsort`` passes ``narrow=False`` to count the same
    executed passes.

    Returns ``sorted_keys``, or ``(sorted_keys, permuted_values)`` with
    values; ``stats`` (a ``SortStats`` of Python numbers) is appended when
    ``return_stats``.
    """
    keys = interop.to_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError("hybrid_sort expects a 1-D key array")
    if values is not None:
        values = interop.tree_to_device(values, keys.device)
    k = bijection.key_bits(keys.dtype)
    cfg = cfg or model.default_config(k // 8)
    if adaptive is None:
        adaptive = cfg.adaptive
    engine = resolve_engine(engine if engine is not None else cfg.rank_engine,
                            keys.device)
    n = keys.shape[0]
    if n == 0:
        out = (keys, values) if values is not None else keys
        if return_stats:
            return (*((out,) if values is None else out),
                    SortStats(0, False, 0, 0, 0))
        return out

    leaves, treedef = interop.tree_flatten(values if values is not None
                                           else ())
    dtypes = [v.dtype for v in leaves]
    with spans.top("hybrid_sort", keys.device, n=n, key_bits=k,
                   value_bytes=sum(v.element_size() for v in leaves),
                   engine=engine):
        # torch cannot scatter or gather uint16/32/64: move their signed
        # twins
        leaves = [v.view(_MOVABLE.get(v.dtype, v.dtype)) for v in leaves]
        ukeys, leaves, state, counters, cplan = _hybrid_sort_bits(
            keys, leaves, cfg, max_passes, engine, adaptive, compress,
            adaptive and narrow)
        with spans.span("hybrid_sort.epilogue"):
            leaves = [v.view(dt) for v, dt in zip(leaves, dtypes)]
            stats = _stats(state, n, counters) if return_stats else None
            if cplan is not None:
                ukeys = bijection.unpack_ordered_bits(ukeys, cplan)
            out_keys = bijection.from_ordered_bits(ukeys, keys.dtype)
            if values is None:
                return (out_keys, stats) if return_stats else out_keys
            vals = interop.tree_unflatten(treedef, leaves)
            return (out_keys, vals, stats) if return_stats else (out_keys,
                                                                 vals)


# --- contract declaration (verified by repro_torch.analysis; see
# analysis/contracts)
# Formulas are symbolic in the structural parameters the analyzer derives per
# (n, cfg): classes = len(local_sort_classes(n, cfg)), passes = ⌈k/d⌉ nominal
# schedule slots, n_pad = fused.pad_length(n, cfg.kpb), kb/vb = key/value
# bytes, vals = payload leaves, g_max/B = descriptor rows / super-step width.
# The port checks them on a recorded run: passes is then the EXECUTED count
# (SortStats.counting_passes), and the loop body is the largest number of
# launches in one iteration (see analysis/contracts).
ANALYSIS_CONTRACT = {
    "entry": "repro_torch.core.hybrid.hybrid_sort",
    "census": {
        "launch_total": "2 + classes",
        "while_body_launches": "[1]",
        "fused_grid": "ceil_div(g_max, B)",
    },
    "sort_free": True,
    "donation": {"_fused_pass_kernel": "1 + vals"},
    "transfer": {
        "sweep_kernels": ["_hist_kernel", "_fused_pass_kernel"],
        "bytes": "(2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb",
    },
}
