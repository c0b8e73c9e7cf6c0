#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together) and drives four paths of
the port, each with the launch counters set to 0 just before it and read
just after:

* the main path, ``repro_torch.hybrid_sort`` at its default engine (which
  must resolve to the kernels), on 2^28 uint32 keys alone and with values,
  Zipf, AND-3, float and int64 keys: every kernel is first held to its
  plain PyTorch version at the shapes the main path gives it (exact
  integer equality; the histogram also on all-equal keys, on views that
  start off a 16-byte boundary and on int64 keys; the fused pass on the
  KV and keys-only passes and on the four passes of the AND-3 keys, whose
  later rows start unaligned; the local sort on every class of the KV and
  keys-only sorts, moving the value leaves as the main path does and
  writing positions, beside ``torch.sort(stable=True)`` of the same buffer
  with the value gather), every sort is checked byte for byte against
  ``torch.sort(stable=True)`` of the ordered-bits carrier, the launch census
  is checked and one sort is profiled; then the same 2^28 KV sort at
  Table 3's (4,0) config with d = 9 (r = 512): its histogram and fused
  passes held to their plain versions at r = 512, the counted sort byte
  for byte against ``torch.sort(stable=True)``, its census checked; then
  (``wide_digits``) the same at wide digits, 2^26 uint32 keys with int32
  values at d = 12 and 2^24 uint32 keys at d = 16 (the fused pass's wide
  variant, the histogram's wide tables, ``merge_rows`` at r = 4096 and
  65536),
  each kernel's time and the wide pass's scratch bytes printed;
* the library surface, each public entry point of
  ``repro_torch.kernels`` whose TPU kernel no sort path calls
  (``bitonic_sort_rows``, ``bitonic_sort_rows_kv``, ``tile_multisplit``,
  ``tile_multisplit_kv``, ``assigned_histogram``), once in a counted run
  and checked by the reference tests' means (sorted rows, pair
  consistency, digit-major tiles, histograms), at the (4,0) config's
  shapes: (2^15, 8192) uint32 rows with int32 values (and keys in
  [0, 1000)), (38 837, 6912) uint32 tiles with int32 values, 43 692
  assigned slots of which 4 855 padding; each kernel is then held to its
  plain version (exact) and timed beside ``torch.sort(dim=1)`` for the
  rows (whose bound is the larger of the bytes and the network's integer
  instructions at the INT32 rate); the row sort over int32, float32 with
  ±0 / NaN / ±inf, int64, float64, uint16, the five float8 formats and
  int4 / uint4 keys (with their special encodings, also with values) and
  the KV row sort at L = 16384 are checked at 2^20 keys, the multisplit
  (keys and KV) and the assigned histogram at widths 9, 12 and 16 on
  (512, 6912) uint32 and uint64 tiles; the multisplit is timed beside
  ``torch.sort(digit, dim=1, stable=True)`` with the gather of keys (and
  values), the assigned histogram beside the gather of its tiles and one
  ``torch.bincount``;
* slice S2 (its ``s2`` phase): ``repro_torch.lsd_sort`` on 2^28 uint32
  keys at d = 5 (the reference's "CUB proxy", 7 passes), with an int32
  index at d = 8 (4 passes; timed at kpb 1024 and 6912, beside the main
  path's hybrid sort of the same records) and on 2^25 int64 keys at d = 8
  (8 passes); ``core.segmented.counting_partition`` of 2^28 int32 ids into
  256, 384 (uniform and Zipf-skewed: Kimi K2's experts) and 65 536
  buckets; ``capacity_dispatch`` at Kimi K2's routing shape (2^17 tokens,
  top-8 of 384 experts, capacity factor 1.25): each the first fused pass
  held to its plain version, the prologue histogram at the partition's
  shape too, every result (at each kpb timed) against
  ``torch.sort(stable=True)`` (and ``torch.bincount``), the
  census (``passes + 1`` for LSD, 2 for a partition), times beside
  ``torch.sort``, byte bounds and scratch bytes;
* the out-of-core path, ``repro_torch.oocsort``, on 2^30 uint32 keys with an
  int32 index value (8 GiB of 8-byte records) in chunks of 2^28, kway 4,
  tile 4096 (4 runs, one merge round): ``merge_check`` holds the merge
  kernel to its plain version on the tables and buffers of that round
  (taken from a profiled run, which also gives the chunk phase's share of
  upload/kernel overlap), and again on the same round cut into tiles
  of 256, ``oocsort``'s default, each timed; ``ooc`` (device-resident) and ``ooc_spill``
  (host spill under a 2^34-byte budget: 5 runs, 2 spilled rounds) are timed
  on the host clock and checked against ``torch.sort(stable=True)`` on the
  card, with merge launches equal to the rounds or strips.  The host's RAM,
  the pinned link rates and an in-core yardstick (upload +
  ``torch.sort`` + download) are printed beside them.

Every phase prints one JSON line.  The line before the last two lists the
kernels (launches on their path, time, bound, plain version's time, library
call's time: ``{"kernels": [...]}``); the next is the card's name and power
limit from ``nvidia-smi``; the last is ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before the last line.  Without a GPU, or without
the repository's ``src/`` beside it, the script exits non-zero and prints
no result.

``--log2n`` shrinks the main sizes (the ooc input is 2^(log2n + 2) keys in
chunks of 2^log2n, the spill budget 2^(log2n + 6) bytes, the library
inputs 2^log2n keys): a quick check;
``--reps`` sets the timed repetitions.  Neither is needed for the full run,
which runs every phase at full size.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per SM per clock (Hopper architecture white paper) and the
#: H100 SXM's maximum boost clock (data sheet): the integer roofline
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def need(cond, what) -> None:
    if not cond:
        raise Failure(what)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def int_ops_ms(torch, ops: float) -> float:
    """Least time for ``ops`` INT32 instructions (per thread) on the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops / (sms * INT32_LANES_PER_SM * BOOST_HZ) * 1e3


def network_bound(torch, res, rows, length, ops_per_exchange):
    """The row network's bound: the larger of its byte bound (already in
    ``res``) and its compare-exchanges times ``ops_per_exchange`` integer
    instructions (a min and a max for keys, a compare and four selects
    with values) at the INT32 rate."""
    lg = length.bit_length() - 1
    exchanges = rows * length // 2 * lg * (lg + 1) // 2
    ops = int_ops_ms(torch, exchanges * ops_per_exchange)
    res.update(byte_bound_ms=res["bound_ms"], ops_bound_ms=ops,
               exchanges=exchanges, ops_per_exchange=ops_per_exchange,
               bound_by="operations" if ops > res["bound_ms"] else "bytes",
               bound_ms=max(ops, res["bound_ms"]))
    emit({"phase": "network_bound", "shape": [rows, length], **{
        k: res[k] for k in ("exchanges", "ops_per_exchange", "byte_bound_ms",
                            "ops_bound_ms", "bound_ms", "bound_by")}})
    return res


def cuda_ms(torch, fn, reps, setup=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up; ``setup`` runs untimed before each."""
    times = []
    for i in range(reps + 1):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, pairs) -> int:
    """Largest |kernel - plain| over integer tensors (0 = equal)."""
    worst = 0
    for a, b in pairs:
        need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            worst = max(worst, int(diff))
    return worst


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise Failure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def environment(torch):
    try:
        import triton
        triton_version = triton.__version__
    except ImportError as exc:
        triton_version = f"not importable ({exc})"
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1] if nvcc else None, "triton": triton_version,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": nvidia_smi_line()})


def build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    usage = {name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "Used" in ln] for name, log in reports.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "dir": os.path.relpath(str(_build.build_dir()), HERE),
          "ptxas": usage})


# --------------------------------------------------------------------------
# capture: the kernels' arguments on a real run of the main path
# --------------------------------------------------------------------------

def capture(torch, keys, values, passes=2, cfg=None):
    """Run ``hybrid_sort`` once (at ``cfg``, else the default config),
    recording clones of the arguments of its
    first ``passes`` fused passes, of its merge_rows calls and of its
    local-sort launches (the key buffer and value leaves before the first
    class, then the class tables).  The recording run is not the counted
    main-path run."""
    from repro_torch.core import plan
    from repro_torch.kernels import fused, ops
    from repro_torch import hybrid_sort
    rec = {"passes": [], "merge": [], "classes": [], "buf": None}
    orig_pass = fused.fused_counting_pass
    orig_merge = plan.merge_rows
    orig_seg = ops.sort_segments_stable

    def pass_hook(src_keys, src_vals, alt_keys, alt_vals, sc, *tables,
                  **kw):
        if len(rec["passes"]) < passes:
            rec["passes"].append(dict(
                src_keys=src_keys.clone(),
                src_vals=tuple(v.clone() for v in src_vals),
                sc=tuple(sc), tables=tuple(t.clone() for t in tables),
                kw=dict(kw)))
        return orig_pass(src_keys, src_vals, alt_keys, alt_vals, sc,
                         *tables, **kw)

    def merge_hook(hist, lt, mt):
        if len(rec["merge"]) < passes:
            rec["merge"].append((hist.clone(), lt, mt))
        return orig_merge(hist, lt, mt)

    def seg_hook(buf, perm, starts, sizes, length, leaves=()):
        if rec["buf"] is None:
            rec["buf"] = buf.clone()
            rec["leaves"] = tuple(v.clone() for v in leaves)
        rec["classes"].append((starts.clone(), sizes.clone(), length))
        return orig_seg(buf, perm, starts, sizes, length, leaves)

    fused.fused_counting_pass = pass_hook
    plan.merge_rows = merge_hook
    ops.sort_segments_stable = seg_hook
    try:
        hybrid_sort(keys, values, cfg=cfg)
    finally:
        fused.fused_counting_pass = orig_pass
        plan.merge_rows = orig_merge
        ops.sort_segments_stable = orig_seg
    torch.cuda.synchronize()
    return rec


# --------------------------------------------------------------------------
# phase 3: every kernel against its plain version, at main-path shapes
# --------------------------------------------------------------------------

def check_histogram(torch, keys_u32, kpb, reps):
    """The prologue histogram (whole-array total) and the (T, r) row
    contract, on uniform and on all-equal keys (the skew worst case)."""
    from repro_torch.core import bijection
    from repro_torch.kernels import fused, histogram, ref
    carrier = bijection.to_ordered_bits(keys_u32)
    n = carrier.shape[0]
    (ck, _), _ = fused.make_ping_pong(carrier, (), kpb)
    out = {}
    for label, buf in (("uniform", ck), ("all_equal", torch.full_like(ck, 7))):
        got = histogram.digit_total(buf, n, 24, 8)
        want = ref.radix_histogram_ref(buf[:n].reshape(1, -1), 24, 8)[0]
        tiles = buf.reshape(-1, kpb)
        err = max_abs_err(torch, [
            (got, want), (histogram.radix_histogram(tiles, 24, 8),
                          ref.radix_histogram_ref(tiles, 24, 8))])
        need(err == 0, f"histogram ({label}) != plain")
        ms = cuda_ms(torch, lambda: histogram.digit_total(buf, n, 24, 8), reps)
        plain = cuda_ms(torch, lambda: ref.radix_histogram_ref(
            buf[:n].reshape(1, -1), 24, 8), max(1, reps // 2))
        # the library yardstick: torch.bincount of the same digits; the
        # digit extraction ((carrier >> 24) & 255) runs outside the timed
        # window (library_ms) and inside it (library_with_digits_ms)
        digits = ((buf[:n] >> 24) & 255).to(torch.int32)
        lib = cuda_ms(torch, lambda: torch.bincount(digits, minlength=256),
                      reps)
        lib_digits = cuda_ms(torch, lambda: torch.bincount(
            ((buf[:n] >> 24) & 255).to(torch.int32), minlength=256), reps)
        need(torch.equal(torch.bincount(digits, minlength=256).to(torch.int32),
                         got), f"torch.bincount ({label}) != histogram")
        del digits
        out[label] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                          bound_ms=bound_ms(n * 4 + 256 * 4),
                          library_ms=lib, library_with_digits_ms=lib_digits)
        emit({"phase": "kernel_check", "kernel": "histogram", "keys": label,
              "n": n, "equal": True, **out[label]})
    # the vector loads' scalar head and tail: a view one key in (its start
    # 4 bytes past a 16-byte boundary) of odd length, and 8-byte keys at
    # the same byte count, each with a view one key in
    i64 = torch.cat([carrier, carrier]).view(torch.int64)
    for label, buf, m, shift in (("unaligned", ck[1:], n - 2, 24),
                                 ("int64", i64, n // 2, 56),
                                 ("int64_unaligned", i64[1:], n // 2 - 3,
                                  56)):
        got = histogram.digit_total(buf, m, shift, 8)
        want = ref.radix_histogram_ref(buf[:m].reshape(1, -1), shift, 8)[0]
        err = max_abs_err(torch, [(got, want)])
        need(err == 0, f"histogram ({label}) != plain")
        ms = cuda_ms(torch, lambda: histogram.digit_total(buf, m, shift, 8),
                     reps)
        emit({"phase": "kernel_check", "kernel": "histogram", "keys": label,
              "n": m, "key_bytes": buf.element_size(),
              "start_mod16": buf.data_ptr() % 16, "equal": True, "ms": ms,
              "bound_ms": bound_ms(m * buf.element_size() + 256 * 4),
              "max_abs_err": err})
    del i64
    return out


def _pass_bytes(torch, rec, n, lookahead):
    """Keys and leaves read and written once, the descriptor rows read,
    of the (a_max, r) base_excl and next_sid tables only the rows of the
    segments that live rows partition, the next-pass histograms written."""
    kb = rec["src_keys"].element_size()
    vb = sum(v.element_size() for v in rec["src_vals"])
    a_max, r = rec["kw"]["a_max"], rec["kw"]["r"]
    seg, _, _, count, active = (t.reshape(-1) for t in rec["tables"][:5])
    segs = torch.unique(seg[(count > 0) & (active > 0)]).numel()
    tables = 5 * seg.numel() * 4 + 2 * segs * r * 4
    return 2 * n * (kb + vb) + tables + a_max * r * 4 * (2 if lookahead else 1)


def check_fused(torch, rec, n, label, reps):
    """The fused pass against its plain version on a captured pass (keys,
    every value leaf and the histograms, exact), then both timed."""
    from repro_torch.kernels import fused, ref
    kw = rec["kw"]

    def run(fn, dev):
        keys = rec["src_keys"].to(dev)
        vals = tuple(v.to(dev) for v in rec["src_vals"])
        alt_k = torch.full_like(keys, -1)
        alt_v = tuple(torch.zeros_like(v) for v in vals)
        tables = tuple(t.to(dev) for t in rec["tables"])
        return fn(keys, vals, alt_k, alt_v, rec["sc"], *tables, **kw)

    dev = rec["src_keys"].device
    want = run(ref.fused_counting_pass_ref, dev)
    got = run(fused.fused_counting_pass, dev)
    pairs = [(got[0][:n], want[0][:n])]
    pairs += [(a[:n], b[:n]) for a, b in zip(got[1], want[1])]
    pairs += list(zip(got[2:], want[2:]))
    err = max_abs_err(torch, pairs)
    need(err == 0, f"fused pass ({label}) != plain")
    del got, want
    keys, vals = rec["src_keys"], rec["src_vals"]
    alt_k = torch.empty_like(keys)
    alt_v = tuple(torch.empty_like(v) for v in vals)
    ms = cuda_ms(torch, lambda: fused.fused_counting_pass(
        keys, vals, alt_k, alt_v, rec["sc"], *rec["tables"], **kw), reps)
    plain = cuda_ms(torch, lambda: ref.fused_counting_pass_ref(
        keys, vals, alt_k, alt_v, rec["sc"], *rec["tables"], **kw),
        max(1, reps // 2))
    _, off, reset, count, active = (t.reshape(-1) for t in
                                    rec["tables"][:5])
    live = (count > 0) & (active > 0)
    unaligned = int((live & (off * keys.element_size() % 16 != 0)).sum())
    res = dict(ms=ms, plain_ms=plain, max_abs_err=err,
               bound_ms=bound_ms(_pass_bytes(torch, rec, n,
                                             kw.get("lookahead", False))),
               rows=off.numel(), live_rows=int(live.sum()),
               unaligned_rows=unaligned,
               regions=int((live & (reset > 0)).sum()))
    emit({"phase": "kernel_check", "kernel": "fused_pass", "pass": label,
          "n": n, "values": len(vals), "lookahead": kw.get("lookahead"),
          "sc": list(rec["sc"]), "equal": True, **res})
    return res


def check_merge_rows(torch, rec, reps):
    from repro_torch.core import plan
    from repro_torch.kernels import ref
    hist, lt, mt = rec
    got = plan.merge_rows(hist, lt, mt)
    want = ref.merge_rows_ref(hist, lt, mt)
    err = max_abs_err(torch, list(zip(got, want)))
    need(err == 0, "merge_rows != plain")
    ms = cuda_ms(torch, lambda: plan.merge_rows(hist, lt, mt), reps)
    plain = cuda_ms(torch, lambda: ref.merge_rows_ref(hist, lt, mt), 1)
    res = dict(ms=ms, plain_ms=plain, max_abs_err=err,
               bound_ms=bound_ms(hist.numel() * 6), rows=hist.shape[0],
               r=hist.shape[1])
    emit({"phase": "kernel_check", "kernel": "merge_rows", "equal": True,
          **res})
    return res


def _local_sort_run(torch, fn, rec, perm):
    """The main path's local sort, class by class, on fresh copies of the
    captured buffer and leaves (``perm``: positions written, no leaves);
    yields after each class."""
    buf = rec["buf"].clone()
    leaves = () if perm else tuple(v.clone() for v in rec["leaves"])
    p = (torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
         if perm else None)
    out = [buf, *leaves] + ([p] if perm else [])
    for starts, sizes, length in rec["classes"]:
        fn(buf, p, starts, sizes, length, leaves)
        yield out


def check_local_sort(torch, rec, reps, label):
    """The local sort on the main path's classes, in its leaf mode (keys
    and value leaves moved in place: the main path) and in perm mode
    (positions written), against its plain version after every class, each
    class timed; then the yardstick: ``torch.sort(stable=True)`` of the same
    buffer with the value gather, which gives the same bytes there (every
    bucket is done and the buckets lie in prefix order)."""
    from repro_torch.core import bijection
    from repro_torch.kernels import bitonic, ref
    n = rec["buf"].shape[0]
    kb = rec["buf"].element_size()
    vb = sum(v.element_size() for v in rec["leaves"])
    res = {}
    for mode in ("leaves", "perm"):
        perm = mode == "perm"
        err = 0
        got = _local_sort_run(torch, bitonic.sort_segments_stable, rec, perm)
        want = _local_sort_run(torch, ref.sort_segments_ref, rec, perm)
        classes = []
        for (starts, sizes, length), g, w in zip(rec["classes"], got, want):
            e = max_abs_err(torch, list(zip(g, w)))
            need(e == 0, f"local sort ({label}, {mode}) class L={length} "
                 f"!= plain")
            err = max(err, e)
            classes.append((starts, sizes, length))
        final = g
        del got, want, w
        scratch = rec["buf"].clone()
        sleaves = () if perm else tuple(v.clone() for v in rec["leaves"])
        sp = (torch.empty(n, dtype=torch.int32, device=scratch.device)
              if perm else None)

        def reset():
            scratch.copy_(rec["buf"])
            for a, b in zip(sleaves, rec["leaves"]):
                a.copy_(b)
            if perm:
                torch.arange(n, out=sp)

        total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for starts, sizes, length in classes:
            live = int((sizes > 0).sum())
            keys_live = int(sizes.sum())
            ms = cuda_ms(torch, lambda: bitonic.sort_segments_stable(
                scratch, sp, starts, sizes, length, sleaves), reps,
                setup=reset)
            plain = cuda_ms(torch, lambda: ref.sort_segments_ref(
                scratch, sp, starts, sizes, length, sleaves), 1, setup=reset)
            # keys read and written; each leaf read and written, or a
            # position written; the size table and the live rows' starts
            nbytes = (keys_live * (2 * kb + (4 if perm else 2 * vb)) +
                      sizes.numel() * 4 + live * 4)
            total["ms"] += ms
            total["plain_ms"] += plain
            total["bound_ms"] += bound_ms(nbytes)
            emit({"phase": "kernel_check", "kernel": "local_sort",
                  "case": label, "mode": mode, "L": length,
                  "rows": sizes.numel(), "live_rows": live,
                  "keys": keys_live, "equal": True, "ms": ms,
                  "plain_ms": plain, "bound_ms": bound_ms(nbytes)})
        res[mode] = dict(total, max_abs_err=err)
        if not perm:
            res["final"] = final
        del scratch, sleaves, sp
    # the yardstick on the same buffer, checked against the kernel's result
    lib_leaves = rec["leaves"]

    def library():
        s = torch.sort(bijection.sortable(rec["buf"]), stable=True)
        return [s.values] + [v[s.indices] for v in lib_leaves]

    lib = library()
    final = res.pop("final")
    need(torch.equal(bijection.sortable(final[0]), lib[0]) and
         all(torch.equal(a, b) for a, b in zip(final[1:], lib[1:])),
         f"local sort ({label}) != torch.sort(stable=True) of its buffer")
    del lib, final
    lib_ms = cuda_ms(torch, library, reps)
    out = dict(res["leaves"], library_ms=lib_ms, perm_ms=res["perm"]["ms"],
               perm_bound_ms=res["perm"]["bound_ms"],
               max_abs_err=max(res["leaves"]["max_abs_err"],
                               res["perm"]["max_abs_err"]))
    emit({"phase": "kernel_check", "kernel": "local_sort_total",
          "case": label, "n": n, "leaves": len(rec["leaves"]),
          "classes": len(rec["classes"]), "equal": True, **out})
    # the (S, L) table contract at the widest class shape
    length = rec["classes"][-1][2]
    dev = rec["buf"].device
    gen = torch.Generator(device=dev).manual_seed(5)
    keys = torch.randint(-2**31, 2**31 - 1, (64, length), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    idx = torch.arange(64 * length, dtype=torch.int32, device=dev).reshape(
        64, length)
    got = bitonic.bitonic_sort_rows_stable(keys, idx)
    want = ref.bitonic_sort_rows_stable_ref(keys, idx)
    e = max_abs_err(torch, list(zip(got, want)))
    need(e == 0, "bitonic_sort_rows_stable != plain")
    emit({"phase": "kernel_check", "kernel": "local_sort_rows",
          "shape": [64, length], "equal": True})
    return out


# --------------------------------------------------------------------------
# library phase: the reference's library-surface kernels (row sorts, tile
# multisplit, descriptor-driven histogram) at the (4,0) config's shapes
# --------------------------------------------------------------------------

#: Table 3's (4,0) config: d = 8, KPB 6912
LIB_KPB = 6912
LIB_ROW = 8192


def _uint_bits(torch, t):
    """Unsigned keys as signed tensors in the same order (top bit flipped):
    what ``torch.sort`` can take for ``uint32``."""
    from repro_torch.core import bijection
    from repro_torch.kernels.ref import int_view
    return bijection.sortable(int_view(t))


def library_inputs(torch, np, log2n, dev):
    """The library phase's inputs from a seed: (2^log2n / 8192, 8192) uint32
    row keys with int32 values and a duplicate-heavy set in [0, 1000);
    (⌈2^log2n / 6912⌉, 6912) uint32 tiles with int32 values; a slot table
    of a seeded permutation of the tiles followed by T/8 padding slots with
    valid 0."""
    rng = np.random.default_rng(1614)
    n = 1 << log2n

    def put(a):
        return torch.from_numpy(a).to(dev)

    rows = n // LIB_ROW
    tiles = -(-n // LIB_KPB)
    pad = -(-tiles // 8)
    tile_idx = np.concatenate([rng.permutation(tiles),
                               np.zeros(pad, np.int64)]).astype(np.int32)
    valid = np.concatenate([np.ones(tiles, np.int32), np.zeros(pad,
                                                                np.int32)])
    return dict(
        row_keys=put(rng.integers(0, 2**32, (rows, LIB_ROW), dtype=np.uint32)),
        dup_keys=put(rng.integers(0, 1000, (rows, LIB_ROW)).astype(np.uint32)),
        row_vals=torch.arange(rows * LIB_ROW, dtype=torch.int32,
                              device=dev).reshape(rows, LIB_ROW),
        tile_keys=put(rng.integers(0, 2**32, (tiles, LIB_KPB),
                                   dtype=np.uint32)),
        tile_vals=torch.arange(tiles * LIB_KPB, dtype=torch.int32,
                               device=dev).reshape(tiles, LIB_KPB),
        tile_idx=put(tile_idx), valid=put(valid))


def library_counted(torch, inp):
    """The library path's counted run: every count set to 0, each public
    entry point called once through ``repro_torch.kernels`` (the KV row
    sort on both key sets), the counts read; then the results checked by
    the reference tests' own means."""
    from repro_torch import kernels as K
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.kernels.ref import int_view
    keys, dup, vals = inp["row_keys"], inp["dup_keys"], inp["row_vals"]
    tk, tv = inp["tile_keys"], inp["tile_vals"]
    torch.cuda.synchronize()
    reset_counts()
    rows = K.bitonic_sort_rows(keys)
    kv = K.bitonic_sort_rows_kv(keys, vals)
    kv_dup = K.bitonic_sort_rows_kv(dup, vals)
    split = K.tile_multisplit(tk, 24, 8, 32)
    split_kv = K.tile_multisplit_kv(tk, tv, 24, 8, 32, 32)
    hist = K.assigned_histogram(tk, inp["tile_idx"], inp["valid"], 24, 8)
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    for name in ("bitonic_rows", "bitonic_rows_kv", "multisplit",
                 "multisplit_kv", "assigned_hist"):
        need(counts[name] > 0, f"library: {name} was not launched: {counts}")
    # rows ascending in unsigned order, equal to torch.sort of the same keys
    want = torch.sort(_uint_bits(torch, keys), dim=1).values
    need(torch.equal(_uint_bits(torch, rows), want),
         "library: bitonic_sort_rows != torch.sort(dim=1)")
    # KV: keys sorted, values a per-row permutation carrying their keys
    for label, src, (ok, ov) in (("uniform", keys, kv), ("dup", dup, kv_dup)):
        need(torch.equal(_uint_bits(torch, ok), torch.sort(
            _uint_bits(torch, src), dim=1).values),
             f"library: bitonic_sort_rows_kv ({label}) keys unsorted")
        need(torch.equal(torch.sort(ov, dim=1).values, vals),
             f"library: bitonic_sort_rows_kv ({label}) values not a "
             f"permutation of each row")
        need(torch.equal(int_view(src).reshape(-1)[ov.reshape(-1).long()],
                         int_view(ok).reshape(-1)),
             f"library: bitonic_sort_rows_kv ({label}) pairs broken")
    del rows, kv, kv_dup
    # multisplit: histograms = the tiles' digit counts, digits non-decreasing
    # per tile, keys a per-tile permutation, ranks restart at each run
    sk, sd, rk, sh = split
    digits = ((int_view(tk) >> 24) & 255).long()
    counted = torch.zeros_like(sh).scatter_add_(
        1, digits, torch.ones_like(digits, dtype=torch.int32))
    need(torch.equal(sh, counted), "library: multisplit histogram wrong")
    need(bool((sd[:, 1:] >= sd[:, :-1]).all()),
         "library: multisplit digits not digit-major")
    need(torch.equal(torch.sort(int_view(sk), dim=1).values,
                     torch.sort(int_view(tk), dim=1).values),
         "library: multisplit keys not a permutation of each tile")
    need(torch.equal(sd, ((int_view(sk) >> 24) & 255).to(torch.int32)),
         "library: multisplit digits do not match its keys")
    need(bool((rk[:, 0] == 0).all()) and bool(
        ((rk[:, 1:] == rk[:, :-1] + 1) | (sd[:, 1:] != sd[:, :-1])).all()),
         "library: multisplit ranks do not count within runs")
    need(all(torch.equal(a, b) for a, b in zip(
        (sk, sd, rk, sh), (split_kv[0],) + tuple(split_kv[2:]))),
         "library: multisplit_kv keys/digits/ranks/hist != multisplit's")
    need(torch.equal(int_view(tk).reshape(-1)[split_kv[1].reshape(-1).long()],
                     int_view(split_kv[0]).reshape(-1)),
         "library: multisplit_kv values do not carry their keys")
    # assigned: slot g = the histogram of its tile, padding slots zero
    t = tk.shape[0]
    need(torch.equal(hist[:t], sh[inp["tile_idx"][:t].long()]),
         "library: assigned_histogram rows != their tiles' histograms")
    need(not bool(hist[t:].any()), "library: padding slots not zero")
    del split, split_kv, sk, sd, rk, sh, digits, counted, hist
    torch.cuda.empty_cache()
    emit({"phase": "library_main_path", "rows": list(keys.shape),
          "tiles": list(tk.shape), "slots": inp["tile_idx"].numel(),
          "launches": {k: counts[k] for k in (
              "bitonic_rows", "bitonic_rows_kv", "multisplit",
              "multisplit_kv", "assigned_hist")}, "equal": True})
    return counts


def _bits_err(torch, got, want) -> int:
    from repro_torch.kernels.ref import int_view
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    need(all(a.dtype == b.dtype for a, b in zip(got, want)),
         "kernel and plain version differ in dtype")
    return max_abs_err(torch, [(int_view(a), int_view(b))
                               for a, b in zip(got, want)])


def library_check(torch, label, kernel, plain, args, reps, nbytes,
                  library=None, **extra):
    """One library kernel against its plain version on the same inputs
    (exact), then timed: kernel (median of ``reps``), plain (one run), the
    library call where there is one."""
    err = _bits_err(torch, kernel(*args), plain(*args))
    need(err == 0, f"{label} != plain version")
    res = dict(max_abs_err=err, ms=cuda_ms(torch, lambda: kernel(*args), reps),
               plain_ms=cuda_ms(torch, lambda: plain(*args), 1),
               bound_ms=bound_ms(nbytes), bound_bytes=nbytes,
               library_ms=(cuda_ms(torch, library, reps) if library
                           else None))
    torch.cuda.empty_cache()
    emit({"phase": "kernel_check", "kernel": label, "equal": True, **extra,
          **res})
    return res


def library_phase(torch, np, log2n, reps, dev):
    """The library phase: the counted run, then each kernel against its
    plain version and timed at full shape, then equality-only checks over
    other key dtypes and the widest local-sort class at 2^20 keys."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import int_view
    inp = library_inputs(torch, np, log2n, dev)
    counts = library_counted(torch, inp)
    keys, dup, vals = inp["row_keys"], inp["dup_keys"], inp["row_vals"]
    n = keys.numel()
    lib_keys = _uint_bits(torch, keys)
    out = {}
    out["bitonic_rows"] = library_check(
        torch, "bitonic_rows", K.bitonic_sort_rows, ref.bitonic_rows_ref,
        (keys,), reps, 2 * n * 4,
        library=lambda: torch.sort(lib_keys, dim=1), shape=list(keys.shape))
    out["bitonic_rows_kv"] = library_check(
        torch, "bitonic_rows_kv", K.bitonic_sort_rows_kv,
        ref.bitonic_rows_ref, (keys, vals), reps, 2 * n * 8,
        library=lambda: torch.sort(lib_keys, dim=1), shape=list(keys.shape))
    dup_res = library_check(
        torch, "bitonic_rows_kv", K.bitonic_sort_rows_kv,
        ref.bitonic_rows_ref, (dup, vals), reps, 2 * n * 8, keys_in="[0,1000)",
        shape=list(keys.shape))
    out["bitonic_rows_kv"]["dup_ms"] = dup_res["ms"]
    network_bound(torch, out["bitonic_rows"], *keys.shape, 2)
    network_bound(torch, out["bitonic_rows_kv"], *keys.shape, 5)
    del lib_keys
    tk, tv = inp["tile_keys"], inp["tile_vals"]
    t, kpb = tk.shape
    nt = tk.numel()
    hist_bytes = t * 256 * 4
    # the library yardstick of rows 7-8: two calls, torch.sort of the
    # tiles' digits (computed outside the timed window) with the gather of
    # the keys (and values) through its order
    bits = int_view(tk)
    digits = ((bits >> 24) & 255).to(torch.int32)

    def sort_gather(*moved):
        order = torch.sort(digits, dim=1, stable=True).indices
        return [torch.gather(m, 1, order) for m in moved]

    out["multisplit"] = library_check(
        torch, "multisplit", K.tile_multisplit,
        lambda k, *a: ref.tile_multisplit_kv_ref(k, None, *a),
        (tk, 24, 8, 32), reps, nt * 4 + nt * 12 + hist_bytes,
        library=lambda: sort_gather(bits), shape=list(tk.shape),
        library_call="torch.sort(digit, dim=1, stable=True) + torch.gather")
    out["multisplit_kv"] = library_check(
        torch, "multisplit_kv", K.tile_multisplit_kv,
        ref.tile_multisplit_kv_ref, (tk, tv, 24, 8, 32, 32), reps,
        nt * 4 + nt * 12 + hist_bytes + 2 * nt * 4,
        library=lambda: sort_gather(bits, tv), shape=list(tk.shape),
        library_call="torch.sort(digit, dim=1, stable=True) + 2 torch.gather")
    del digits
    idx, valid = inp["tile_idx"], inp["valid"]
    g = idx.numel()
    # row 9's: the gather of its tiles plus one torch.bincount of their
    # digits offset by slot, scaled by valid
    slot_base = (torch.arange(g, device=dev, dtype=torch.int64) * 256)[:, None]

    def gather_bincount():
        sel = bits.index_select(0, idx.long())
        counts = torch.bincount((((sel >> 24) & 255) + slot_base).flatten(),
                                minlength=g * 256)
        return counts.view(g, 256).to(torch.int32) * valid[:, None]

    need(torch.equal(gather_bincount(), ref.assigned_histogram_ref(
        tk, idx, valid, 24, 8)), "library: gather + bincount != assigned")
    out["assigned_hist"] = library_check(
        torch, "assigned_hist", K.assigned_histogram,
        ref.assigned_histogram_ref, (tk, idx, valid, 24, 8), reps,
        int(valid.ne(0).sum()) * kpb * 4 + g * 256 * 4, slots=g,
        library=gather_bincount,
        library_call="index_select + torch.bincount")
    for key in list(inp):
        del inp[key]
    del keys, dup, vals, tk, tv, idx, valid, bits
    torch.cuda.empty_cache()
    library_dtypes(torch, np, dev)
    library_wide(torch, np, dev)
    return out, counts


def library_wide(torch, np, dev):
    """Equality-only checks of the multisplit (keys and KV) and the
    assigned histogram at digit widths 9, 12 and 16 (two 8-bit rounds;
    the assigned histogram's shared table, and global atomics past 14
    bits), on (512, 6912) uint32 tiles and on uint64 tiles."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    rng = np.random.default_rng(1617)
    shape = (512, LIB_KPB)
    checked = []
    for dtype, bits in ((np.uint32, 32), (np.uint64, 64)):
        x = rng.integers(0, 2**bits - 1, shape, dtype=dtype)
        x[7] = x[7, 0]                                   # an all-equal tile
        keys = torch.from_numpy(x).to(dev)
        vals = torch.arange(keys.numel(), dtype=torch.int32,
                            device=dev).reshape(shape)
        idx = torch.from_numpy(np.concatenate([
            rng.permutation(shape[0]), [-1, 600]]).astype(np.int32)).to(dev)
        valid = torch.ones_like(idx)
        valid[:3] = torch.tensor([0, 2, -3], dtype=torch.int32)
        for width in (9, 12, 16):
            shift = bits - width - 1
            cases = (
                ("multisplit", K.tile_multisplit,
                 lambda k, *a: ref.tile_multisplit_kv_ref(k, None, *a),
                 (keys, shift, width, bits)),
                ("multisplit_kv", K.tile_multisplit_kv,
                 ref.tile_multisplit_kv_ref,
                 (keys, vals, shift, width, bits, 32)),
                ("assigned_hist", K.assigned_histogram,
                 ref.assigned_histogram_ref,
                 (keys, idx, valid, shift, width)))
            for label, kernel, plain, args in cases:
                err = _bits_err(torch, kernel(*args), plain(*args))
                need(err == 0, f"{label} (width {width}, {bits}-bit keys) "
                     f"!= plain version")
            checked.append([bits, width])
        del keys, vals
        torch.cuda.empty_cache()
    emit({"phase": "library_wide", "tiles": list(shape),
          "kernels": ["multisplit", "multisplit_kv", "assigned_hist"],
          "key_bits_and_widths": checked, "equal": True})


def library_dtypes(torch, np, dev):
    """Equality-only checks at 2^20 keys: the row sort over other key
    dtypes (floats with ±0, NaN and ±inf rows; the float8 formats and the
    4-bit integers with their special encodings, also with values) and the
    KV row sort at L = 16384, the (4,0) config's widest local-sort class
    (∂̂ 9216)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    rng = np.random.default_rng(1615)
    shape = (128, LIB_ROW)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    f32 = rng.standard_normal(shape).astype(np.float32)
    f32[0] = np.resize(np.array([0.0, -0.0], np.float32), LIB_ROW)
    f32[1, 100] = np.nan
    f32[2, ::3] = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    f32[2, 1::3] = -np.inf
    f32[3] = np.resize(np.array([np.inf, -np.inf, -0.0], np.float32),
                       LIB_ROW)
    cases = {
        "int32": put(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                     .astype(np.int32)),
        "float32_specials": put(f32),
        "int64": put(rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)),
        "float64": put(rng.standard_normal(shape)),
        "uint16": put(rng.integers(0, 2**16, shape, dtype=np.uint16)),
    }
    # one-byte kinds: random bytes with a third of the lanes drawn from
    # each format's NaNs, ±0, infinities and subnormals (and 4-bit values
    # with high-nibble bits), keys alone and with int32 values
    specials = np.array([0x00, 0x80, 0x7F, 0xFF, 0x7E, 0xFE, 0x7C, 0xFC,
                         0x7D, 0x01, 0x81, 0x03, 0x83, 0x18, 0xF3], np.uint8)
    byte_vals = torch.arange(shape[0] * shape[1], dtype=torch.int32,
                             device=dev).reshape(shape)
    byte_kinds = ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                  "float8_e5m2fnuz", "float8_e8m0fnu", "int4", "uint4")
    for name in byte_kinds:
        bits = rng.integers(0, 256, shape, dtype=np.uint8)
        at = rng.random(shape) < 0.33
        bits[at] = rng.choice(specials, int(at.sum()))
        keys = put(bits).view(getattr(torch, name))
        err = _bits_err(torch, K.bitonic_sort_rows_kv(keys, byte_vals),
                        ref.bitonic_rows_ref(keys, byte_vals))
        need(err == 0, f"bitonic_rows_kv ({name}) != plain version")
        cases[name] = keys
    for label, keys in cases.items():
        err = _bits_err(torch, K.bitonic_sort_rows(keys),
                        ref.bitonic_rows_ref(keys))
        need(err == 0, f"bitonic_rows ({label}) != plain version")
    keys = put(rng.integers(0, 2**32, (64, 16384), dtype=np.uint32))
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    err = _bits_err(torch, K.bitonic_sort_rows_kv(keys, vals),
                    ref.bitonic_rows_ref(keys, vals))
    need(err == 0, "bitonic_rows_kv (L = 16384) != plain version")
    emit({"phase": "library_dtypes", "keys": 1 << 20,
          "rows": sorted(cases), "kv_rows": list(byte_kinds),
          "kv_row_len": 16384, "equal": True})
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def reference_sort(torch, keys):
    """Keys and stable source indices of ``torch.sort(stable=True)`` over the
    ordered-bits carrier (totalOrder for floats), mapped back."""
    from repro_torch.core import bijection
    carrier = bijection.to_ordered_bits(keys)
    s = torch.sort(bijection.sortable(carrier), stable=True)
    return (bijection.from_ordered_bits(bijection.sortable(s.values),
                                        keys.dtype), s.indices)


def same_bits(torch, a, b) -> bool:
    from repro_torch.core import bijection
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool(torch.equal(bijection.to_ordered_bits(a),
                            bijection.to_ordered_bits(b)))


def main_case(torch, label, keys, with_values, reps, cfg=None):
    from repro_torch import hybrid_sort
    from repro_torch.core import bijection, hybrid, model
    from repro_torch.core.ranks import resolve_engine
    from repro_torch.kernels import COUNTS, reset_counts, fused
    n = keys.shape[0]
    need(resolve_engine(None, keys.device) == "kernel",
         "auto engine did not resolve to the kernels on CUDA")
    values = (torch.arange(n, dtype=torch.int32, device=keys.device)
              if with_values else None)
    kb = keys.element_size()
    cfg = cfg or model.default_config(kb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    if with_values:
        out_k, out_v, stats = hybrid_sort(keys, values, cfg=cfg,
                                          return_stats=True)
    else:
        out_k, stats = hybrid_sort(keys, cfg=cfg, return_stats=True)
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    peak = torch.cuda.max_memory_allocated() - base_mem
    ref_k, ref_i = reference_sort(torch, keys)
    need(same_bits(torch, out_k, ref_k), f"{label}: keys differ from torch.sort")
    if with_values:
        need(torch.equal(out_v.to(torch.int64), ref_i),
             f"{label}: values differ from torch.sort(stable=True) indices")
    del ref_k, ref_i
    classes = len(hybrid.local_sort_classes(n, cfg))
    need(counts["histogram"] == 1, f"{label}: histogram launches "
         f"{counts['histogram']} != 1")
    need(counts["fused_pass"] == stats.counting_passes,
         f"{label}: fused launches {counts['fused_pass']} != "
         f"{stats.counting_passes} executed passes")
    need(counts["local_sort"] <= classes,
         f"{label}: local-sort launches {counts['local_sort']} > {classes}")
    # the yardstick: torch.sort (CUB's radix sort on CUDA) of the same keys;
    # unsigned keys go as their signed view (torch.sort has no uint32), which
    # moves the same bytes through the same number of radix passes
    lib_keys = (keys.view(bijection.carrier_dtype(keys.dtype))
                if keys.dtype in (torch.uint32, torch.uint64) else keys)
    if with_values:
        ms = cuda_ms(torch, lambda: hybrid_sort(keys, values, cfg=cfg), reps)
        lib = cuda_ms(torch, lambda: torch.sort(lib_keys, stable=True), reps)
    else:
        ms = cuda_ms(torch, lambda: hybrid_sort(keys, cfg=cfg), reps)
        lib = cuda_ms(torch, lambda: torch.sort(lib_keys), reps)
    p = stats.counting_passes
    n_pad = fused.pad_length(n, cfg.kpb)
    vb = 4 if with_values else 0
    model_bytes = ((2 * p + 1) * n_pad * kb + 2 * p * n_pad * vb +
                   (2 * n * (kb + vb) if stats.used_local_sort else 0))
    res = {"phase": "main_path", "case": label, "n": n,
           "dtype": str(keys.dtype).replace("torch.", ""),
           "values": with_values, "engine": "kernel", "equal": True,
           "d": cfg.d, "kpb": cfg.kpb,
           "stats": stats._asdict(), "launches": counts,
           "local_sort_classes": classes, "ms": ms, "torch_sort_ms": lib,
           "byte_model": model_bytes, "byte_model_bound_ms":
           bound_ms(model_bytes), "peak_mem_bytes": peak}
    emit(res)
    return res


def profile_case(torch, keys, with_values):
    """Where the time of one sort goes: ``torch.profiler`` over one run
    (after a warm-up), device time by kernel/op name, and the device's busy
    share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import hybrid_sort
    values = (torch.arange(keys.shape[0], dtype=torch.int32,
                           device=keys.device) if with_values else None)
    hybrid_sort(keys, values)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hybrid_sort(keys, values)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        # device-side entries only (kernels, memsets, copies): a CPU op's
        # device time is the sum of its kernels, which are listed as well
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "n": keys.shape[0], "values": with_values,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
          "top": [{"name": name[:80], "calls": count, "device_ms": ms}
                  for ms, count, name in rows[:15]]})


#: Table 3's (4,0) config with 9-bit digits (r = 512)
D9 = dict(d=9, kpb=6912, local_threshold=9216, merge_threshold=3000)


def d9_phase(torch, np, log2n, reps, dev):
    """The main path at d = 9 on 2^log2n uint32 keys with an int32 index:
    the prologue histogram at r = 512 (total and rows) and every fused pass
    of the sort held to their plain versions, then the counted sort, byte
    for byte against ``torch.sort(stable=True)``, with its census."""
    from repro_torch.core import bijection, hybrid, plan
    from repro_torch.core.model import SortConfig
    from repro_torch.kernels import fused, histogram, ref
    cfg = SortConfig(**D9)
    n = 1 << log2n
    keys = torch.from_numpy(np.random.default_rng(2017).integers(
        0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    (ck, _), _ = fused.make_ping_pong(bijection.to_ordered_bits(keys), (),
                                      cfg.kpb)
    lo, width = plan.digit_window(0, 32, cfg.d)[:2]
    tiles = ck.reshape(-1, cfg.kpb)
    err = max_abs_err(torch, [
        (histogram.digit_total(ck, n, lo, width),
         ref.radix_histogram_ref(ck[:n].reshape(1, -1), lo, width)[0]),
        (histogram.radix_histogram(tiles, lo, width),
         ref.radix_histogram_ref(tiles, lo, width))])
    need(err == 0, "histogram (d = 9) != plain")
    hist_ms = cuda_ms(torch, lambda: histogram.digit_total(ck, n, lo, width),
                      reps)
    del ck, tiles
    emit({"phase": "kernel_check", "kernel": "histogram", "keys": "d9",
          "n": n, "width": width, "equal": True, "ms": hist_ms,
          "bound_ms": bound_ms(n * 4 + (1 << width) * 4),
          "max_abs_err": err})
    rec = capture(torch, keys, vals, passes=8, cfg=cfg)
    need(rec["passes"] and all(r["kw"]["r"] == 512 for r in rec["passes"]),
         "d = 9: the fused passes did not run at r = 512")
    fused_res = [check_fused(torch, r, n, f"d9_kv_pass{i}", reps)
                 for i, r in enumerate(rec["passes"])]
    del rec
    torch.cuda.empty_cache()
    res = main_case(torch, "uint32_uniform_kv_d9", keys, True, reps,
                    cfg=cfg)
    launches = res["launches"]
    classes = len(hybrid.local_sort_classes(n, cfg))
    passes = res["stats"]["counting_passes"]
    need(launches["histogram"] + launches["fused_pass"] ==
         1 + passes and launches["local_sort"] <= classes,
         f"d = 9: census {launches} against 1 histogram, {passes} passes "
         f"and at most {classes} local sorts")
    emit({"phase": "d9_census", "histogram": launches["histogram"],
          "fused_pass": launches["fused_pass"], "passes": passes,
          "local_sort": launches["local_sort"], "classes": classes,
          "static_census": 2 + classes})
    return res, fused_res


#: the main path at wide digits, Table 3's (4,0) config with d = 12 (2^26
#: uint32 keys with int32 values, 3 nominal passes) and d = 16 (2^24 uint32
#: keys alone, 2 nominal passes: at 2^28 the plan's (a_max, r) tables
#: would be about 7.6 GB each); log2 n below the main size
WIDE = ((12, 2, True), (16, 4, False))


def wide_case(torch, np, d, n, with_values, reps, dev):
    """One wide-digit sort: the prologue histogram (total and rows) and
    every fused pass held to their plain versions and timed, merge_rows at
    this r, then the counted sort byte for byte against
    ``torch.sort(stable=True)`` with its census."""
    from repro_torch.core import bijection, hybrid, plan
    from repro_torch.core.model import SortConfig
    from repro_torch.kernels import fused, histogram, ref
    cfg = SortConfig(**dict(D9, d=d))
    label = f"uint32_uniform{'_kv' if with_values else ''}_d{d}"
    keys = torch.from_numpy(np.random.default_rng(2017 + d).integers(
        0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = (torch.arange(n, dtype=torch.int32, device=dev) if with_values
            else None)
    (ck, _), _ = fused.make_ping_pong(bijection.to_ordered_bits(keys), (),
                                      cfg.kpb)
    lo, width = plan.digit_window(0, 32, d)[:2]
    tiles = ck.reshape(-1, cfg.kpb)
    err = max_abs_err(torch, [
        (histogram.digit_total(ck, n, lo, width),
         ref.radix_histogram_ref(ck[:n].reshape(1, -1), lo, width)[0]),
        (histogram.radix_histogram(tiles, lo, width),
         ref.radix_histogram_ref(tiles, lo, width))])
    need(err == 0, f"histogram (d = {d}) != plain")
    digits = ((ck[:n] >> lo) & ((1 << width) - 1)).to(torch.int32)
    hist = dict(
        ms=cuda_ms(torch, lambda: histogram.digit_total(ck, n, lo, width),
                   reps),
        plain_ms=cuda_ms(torch, lambda: ref.radix_histogram_ref(
            ck[:n].reshape(1, -1), lo, width), max(1, reps // 2)),
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            digits, minlength=1 << width), reps),
        bound_ms=bound_ms(n * 4 + (1 << width) * 4), max_abs_err=err)
    del ck, tiles, digits
    emit({"phase": "kernel_check", "kernel": "histogram", "keys": label,
          "n": n, "width": width, "equal": True, **hist})
    rec = capture(torch, keys, vals, passes=8, cfg=cfg)
    need(rec["passes"] and all(r["kw"]["r"] == 1 << d for r in rec["passes"]),
         f"d = {d}: the fused passes did not run at r = {1 << d}")
    passes = []
    for i, r in enumerate(rec["passes"]):
        rows = r["tables"][0].numel()
        res = check_fused(torch, r, n, f"{label}_pass{i}", reps)
        res["scratch_bytes"] = fused.scratch_bytes(
            rows, r["kw"]["r"], n, r["src_keys"].shape[0])
        passes.append(res)
    merge = check_merge_rows(torch, rec["merge"][0], max(1, reps // 2))
    del rec
    torch.cuda.empty_cache()
    res = main_case(torch, label, keys, with_values, reps, cfg=cfg)
    launches = res["launches"]
    classes = len(hybrid.local_sort_classes(n, cfg))
    executed = res["stats"]["counting_passes"]
    need(launches["histogram"] == 1 and launches["fused_pass"] == executed
         and launches["local_sort"] <= classes,
         f"d = {d}: census {launches} against 1 histogram, {executed} "
         f"passes and at most {classes} local sorts")
    need(len(passes) == executed,
         f"d = {d}: {len(passes)} passes checked of {executed} executed")
    emit({"phase": "wide_digits", "case": label, "n": n, "d": d,
          "sort_ms": res["ms"], "torch_sort_ms": res["torch_sort_ms"],
          "histogram_ms": hist["ms"],
          "fused_pass_ms": [r["ms"] for r in passes],
          "fused_pass_bound_ms": [r["bound_ms"] for r in passes],
          "fused_scratch_bytes": [r["scratch_bytes"] for r in passes],
          "merge_rows_ms": merge["ms"],
          "census": {"histogram": launches["histogram"],
                     "fused_pass": launches["fused_pass"],
                     "passes": executed, "local_sort": launches["local_sort"],
                     "classes": classes}})
    return dict(sort=res, histogram=hist, passes=passes, merge_rows=merge)


def wide_phase(torch, np, log2n, reps, dev):
    """The main path at d = 12 and d = 16 (the fused pass's wide variant,
    the histogram's wide tables), each case its own counted run."""
    out = {}
    for d, below, with_values in WIDE:
        out[d] = wide_case(torch, np, d, 1 << (log2n - below), with_values,
                           reps, dev)
        torch.cuda.empty_cache()
    return out


def make_cases(torch, np, log2n, dev):
    """(label, keys tensor, with_values) for the main path, from seeds."""
    rng = np.random.default_rng(2016)
    big = 1 << log2n
    mid = 1 << max(log2n - 2, 10)
    small = 1 << max(log2n - 3, 10)

    def put(a):
        return torch.from_numpy(a).to(dev)

    uni = rng.integers(0, 2**32, big, dtype=np.uint32)
    yield "uint32_uniform", put(uni), False
    yield "uint32_uniform_kv", put(uni), True
    del uni
    zipf = np.minimum(rng.zipf(1.5, mid), 2**32 - 1).astype(np.uint32)
    yield "uint32_zipf1.5", put(zipf), False
    del zipf
    ent = rng.integers(0, 2**32, big, dtype=np.uint32)
    for _ in range(3):
        ent &= rng.integers(0, 2**32, big, dtype=np.uint32)
    yield "uint32_and3", put(ent), False
    del ent
    f = (rng.standard_normal(mid) * 1e3).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf], np.float32)
    nans = np.array([0x7fc00000, 0xffc00000, 0x7f800001, 0xff800123],
                    np.uint32).view(np.float32)
    at = rng.choice(mid, 4096, replace=False)
    f[at] = np.resize(np.concatenate([specials, nans]), 4096)
    yield "float32_specials", put(f), True
    del f
    i64 = rng.integers(-2**63, 2**63 - 1, small, dtype=np.int64)
    yield "int64_uniform", put(i64), False


# --------------------------------------------------------------------------
# phase s2: the LSD sort and the single-pass partition (slice S2)
# --------------------------------------------------------------------------

#: the LSD cases: (label, key dtype, d, with an int32 index, log2 n below
#: the main size, kpb values timed): the reference's "CUB proxy" (d = 5, 7
#: passes); the main path's KV records at d = 8 (4 passes), timed at the
#: reference's kpb 1024 and at the hybrid sort's 6912; 8-byte keys (8
#: passes)
LSD_CASES = (("uint32_d5", "uint32", 5, False, 0, (1024,)),
             ("uint32_kv_d8", "uint32", 8, True, 0, (1024, 6912)),
             ("int64_d8", "int64", 8, False, 3, (1024,)))
#: the partition cases: (label, buckets, ids, fused pass held to its plain
#: version): a join side's radix partition (256), Kimi K2's experts
#: (configs/kimi_k2_1t_a32b.py: 384, d = 9) uniform and Zipf-skewed, and
#: 65 536 buckets (the fused pass's wide variant)
PARTITION_CASES = (("uniform_256", 256, "uniform", False),
                   ("uniform_384", 384, "uniform", True),
                   ("zipf_384", 384, "zipf", False),
                   ("uniform_65536", 65536, "uniform", True))
#: Kimi K2's routing: 384 experts, top-8, capacity factor 1.25; 2^17 tokens
KIMI_EXPERTS, KIMI_TOP_K, KIMI_TOKENS = 384, 8, 1 << 17


def first_pass(torch, run):
    """Runs ``run()`` once, recording clones of its first fused pass's
    arguments (``check_fused``'s record); the recording run is not a
    counted one."""
    from repro_torch.kernels import fused
    rec = []
    orig = fused.fused_counting_pass

    def hook(src_keys, src_vals, alt_keys, alt_vals, sc, *tables, **kw):
        if not rec:
            rec.append(dict(src_keys=src_keys.clone(),
                            src_vals=tuple(v.clone() for v in src_vals),
                            sc=tuple(sc),
                            tables=tuple(t.clone() for t in tables),
                            kw=dict(kw)))
        return orig(src_keys, src_vals, alt_keys, alt_vals, sc, *tables,
                    **kw)

    fused.fused_counting_pass = hook
    try:
        run()
    finally:
        fused.fused_counting_pass = orig
    torch.cuda.synchronize()
    need(rec, "no fused pass was recorded")
    return rec[0]


def _scratch(rec, n):
    from repro_torch.kernels import fused
    return fused.scratch_bytes(rec["tables"][0].numel(), rec["kw"]["r"], n,
                               rec["src_keys"].shape[0])


def lsd_case(torch, np, label, dtype, d, with_values, n, kpbs, reps, dev):
    """One LSD sort: its first fused pass held to the plain version
    (exact), the counted sort byte for byte against
    ``torch.sort(stable=True)`` with its census (1 prologue histogram + one
    fused pass per pass), then at each kpb checked the same way and timed
    beside ``torch.sort``, its
    byte bound ``(2p+1)·n_pad·kb + 2p·n_pad·vb`` and its scratch bytes, and
    (KV) beside the main path's hybrid sort of the same records."""
    from repro_torch import hybrid_sort, lsd_sort
    from repro_torch.core import bijection, plan
    from repro_torch.kernels import COUNTS, fused, reset_counts
    info = np.iinfo(dtype)
    keys = torch.from_numpy(np.random.default_rng(1900 + d).integers(
        info.min, info.max, n, dtype=dtype, endpoint=True)).to(dev)
    vals = (torch.arange(n, dtype=torch.int32, device=dev) if with_values
            else None)
    rec = first_pass(torch, lambda: lsd_sort(keys, vals, d=d, kpb=kpbs[0]))
    fres = check_fused(torch, rec, n, f"lsd_{label}_pass0", reps)
    fres["scratch_bytes"] = _scratch(rec, n)
    del rec
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    out = lsd_sort(keys, vals, d=d, kpb=kpbs[0], return_passes=True)
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    passes = out[-1]
    ref_k, ref_i = reference_sort(torch, keys)

    def check(out, kpb):
        need(same_bits(torch, out[0], ref_k),
             f"lsd {label} kpb {kpb}: keys differ from torch.sort(stable="
             f"True)")
        if with_values:
            need(torch.equal(out[1].to(torch.int64), ref_i),
                 f"lsd {label} kpb {kpb}: values differ from torch.sort "
                 f"indices")

    check(out, kpbs[0])
    del out
    for kpb in kpbs[1:]:
        check(lsd_sort(keys, vals, d=d, kpb=kpb, return_passes=True), kpb)
    del ref_k, ref_i
    k = 8 * keys.element_size()
    need(passes == -(-k // d), f"lsd {label}: {passes} passes of uniform "
         f"keys, expected {-(-k // d)}")
    need(counts["histogram"] == 1 and counts["fused_pass"] == passes,
         f"lsd {label}: census {counts} against 1 histogram and {passes} "
         f"fused passes")
    lib_keys = (keys.view(bijection.carrier_dtype(keys.dtype))
                if keys.dtype in (torch.uint32, torch.uint64) else keys)
    lib = cuda_ms(torch, lambda: torch.sort(lib_keys, stable=True), reps)
    kb, vb = keys.element_size(), (4 if with_values else 0)
    timed = {}
    for kpb in kpbs:
        n_pad = fused.pad_length(n, kpb)
        model = (2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb
        timed[kpb] = dict(
            ms=cuda_ms(torch, lambda: lsd_sort(keys, vals, d=d, kpb=kpb),
                       reps),
            byte_model=model, bound_ms=bound_ms(model),
            scratch_bytes=fused.scratch_bytes(
                plan.max_region_blocks(n, kpb, 1), 1 << d, n, n_pad))
    hybrid = (cuda_ms(torch, lambda: hybrid_sort(keys, vals), reps)
              if with_values else None)
    res = {"phase": "s2", "case": f"lsd_{label}", "n": n,
           "dtype": str(keys.dtype).replace("torch.", ""), "d": d,
           "values": with_values, "equal": True, "passes": passes,
           "census": {"histogram": counts["histogram"],
                      "fused_pass": counts["fused_pass"],
                      "total": counts["histogram"] + counts["fused_pass"]},
           "host_reads": counts["host_reads"],
           "by_kpb": {str(kpb): v for kpb, v in timed.items()},
           "torch_sort_ms": lib, "hybrid_sort_same_records_ms": hybrid,
           "fused_pass0": fres}
    emit(res)
    return dict(res, launches=counts, fused=fres)


def partition_ids(np, kind, buckets, m):
    """2^log2n int32 bucket ids from a seed: uniform, or Zipf(1.2) ranks
    (``repro_torch.data.zipf_keys``) folded into the buckets."""
    from repro_torch.data import zipf_keys
    if kind == "zipf":
        z = zipf_keys(np.random.default_rng(1901), m, 1.2, np.uint32)
        return ((z - np.uint32(1)) % np.uint32(buckets)).astype(np.int32)
    return np.random.default_rng(1902 + buckets).integers(
        0, buckets, m).astype(np.int32)


def partition_case(torch, np, label, buckets, kind, check_pass, m, reps,
                   dev):
    """One ``counting_partition``: (optionally) its fused pass held to the
    plain version, then the counted call against ``torch.sort(stable=
    True)`` and ``torch.bincount`` with its census (2 launches), timed
    beside those two calls, and again at kpb 6912, checked the same way,
    with the scratch bytes of both.  Its bound: the ids read once,
    ``dest`` and ``perm`` written once."""
    from repro_torch.core import plan, segmented
    from repro_torch.kernels import COUNTS, fused, reset_counts
    ids = torch.from_numpy(partition_ids(np, kind, buckets, m)).to(dev)
    fres = None
    if check_pass:
        rec = first_pass(torch, lambda: segmented.counting_partition(
            ids, buckets))
        fres = check_fused(torch, rec, m, f"partition_{label}", reps)
        fres["scratch_bytes"] = _scratch(rec, m)
        del rec
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    part = segmented.counting_partition(ids, buckets)
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    want = torch.sort(ids, stable=True).indices
    want_counts = torch.bincount(ids, minlength=buckets).to(torch.int32)
    iota = torch.arange(m, dtype=torch.int32, device=dev)

    def check(dest, perm, cnt, kpb):
        need(torch.equal(perm.to(torch.int64), want),
             f"partition {label} kpb {kpb}: perm != torch.sort(stable="
             f"True).indices")
        need(torch.equal(dest[perm.long()], iota),
             f"partition {label} kpb {kpb}: dest is not the inverse of perm")
        need(torch.equal(cnt, want_counts),
             f"partition {label} kpb {kpb}: counts != torch.bincount")

    check(part.dest, part.perm, part.counts, 1024)
    need(counts["histogram"] == 1 and counts["fused_pass"] == 1,
         f"partition {label}: census {counts}, expected 1 + 1")
    del part
    check(*plan.single_pass_partition(ids, buckets, kpb=6912), 6912)
    del want, want_counts, iota
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: segmented.counting_partition(ids, buckets),
                 reps)
    lib = cuda_ms(torch, lambda: (torch.sort(ids, stable=True),
                                  torch.bincount(ids, minlength=buckets)),
                  reps)
    # the reference's kpb (1024, counting_partition's) and the hybrid
    # sort's (6912, through plan.single_pass_partition)
    r = 1 << max(1, (buckets - 1).bit_length())
    by_kpb = {}
    for kpb in (1024, 6912):
        n_pad = fused.pad_length(m, kpb)
        by_kpb[str(kpb)] = dict(
            ms=ms if kpb == 1024 else cuda_ms(
                torch, lambda: plan.single_pass_partition(ids, buckets,
                                                          kpb=kpb), reps),
            scratch_bytes=fused.scratch_bytes(
                plan.max_region_blocks(m, kpb, 1), r, m, n_pad),
            pass_byte_model_bound_ms=bound_ms(3 * n_pad * 4 + 2 * n_pad * 4))
    res = {"phase": "s2", "case": f"partition_{label}", "n": m,
           "buckets": buckets, "ids": kind, "equal": True,
           "census": {"histogram": counts["histogram"],
                      "fused_pass": counts["fused_pass"],
                      "total": counts["histogram"] + counts["fused_pass"]},
           "ms": ms, "torch_sort_bincount_ms": lib,
           "bound_ms": bound_ms(12 * m + 4 * buckets), "by_kpb": by_kpb,
           "largest_bucket": int(torch.bincount(ids).max()),
           "fused_pass": fres}
    emit(res)
    return dict(res, launches=counts, fused=fres, ids=ids)


def check_histogram_s2(torch, ids, width, reps):
    """The prologue histogram at the partition's shape (the ids padded as
    the single pass pads them), against its plain version, timed beside
    ``torch.bincount``."""
    from repro_torch.kernels import fused, histogram, ref
    m = ids.numel()
    (ck, _), _ = fused.make_ping_pong(ids, (), 1024)
    err = max_abs_err(torch, [(histogram.digit_total(ck, m, 0, width),
                               ref.radix_histogram_ref(
                                   ck[:m].reshape(1, -1), 0, width)[0])])
    need(err == 0, "histogram (partition) != plain")
    res = dict(ms=cuda_ms(torch, lambda: histogram.digit_total(
        ck, m, 0, width), reps),
        plain_ms=cuda_ms(torch, lambda: ref.radix_histogram_ref(
            ck[:m].reshape(1, -1), 0, width), max(1, reps // 2)),
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            ids, minlength=1 << width), reps),
        bound_ms=bound_ms(m * 4 + (1 << width) * 4), max_abs_err=err)
    emit({"phase": "kernel_check", "kernel": "histogram", "keys":
          "partition_ids", "n": m, "width": width, "equal": True, **res})
    return res


def dispatch_case(torch, reps, dev):
    """``capacity_dispatch`` at Kimi K2's routing shape (2^17 tokens, top-8
    of 384 experts from seeded router scores, the first 32 experts slightly
    favoured so that some overflow; capacity ⌈1.25·m/384⌉), every field
    against the same layout built from ``torch.sort(stable=True)``."""
    import math
    from repro_torch.core import segmented
    from repro_torch.kernels import COUNTS, reset_counts
    gen = torch.Generator(device=dev).manual_seed(2019)
    scores = torch.rand((KIMI_TOKENS, KIMI_EXPERTS), generator=gen,
                        device=dev)
    scores[:, :32] += 0.01
    ids = scores.topk(KIMI_TOP_K, dim=1).indices.to(torch.int32).reshape(-1)
    del scores
    m, e = ids.numel(), KIMI_EXPERTS
    cap = math.ceil(1.25 * m / e)
    torch.cuda.synchronize()
    reset_counts()
    got = segmented.capacity_dispatch(ids, e, cap)
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    need(counts["histogram"] == 1 and counts["fused_pass"] == 1,
         f"capacity_dispatch: census {counts}, expected 1 + 1")
    perm = torch.sort(ids, stable=True).indices
    cnt = torch.bincount(ids, minlength=e).to(torch.int32)
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    dest = torch.empty(m, dtype=torch.int32, device=dev)
    dest[perm] = torch.arange(m, dtype=torch.int32, device=dev)
    position = dest - off[ids.long()]
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    src = (off[:, None] + j[None, :]).clamp(max=m - 1)
    valid = j[None, :] < cnt[:, None]
    gather = torch.where(valid, perm[src.long()].to(torch.int32), m)
    want = segmented.CapacityDispatch(
        gather_idx=gather, slot_valid=valid, position=position,
        kept=position < cap, counts=cnt)
    for name, a, b in zip(want._fields, got, want):
        need(a.dtype == b.dtype and torch.equal(a, b),
             f"capacity_dispatch: {name} != the torch.sort layout")
    ms = cuda_ms(torch, lambda: segmented.capacity_dispatch(ids, e, cap),
                 reps)
    res = {"phase": "s2", "case": "capacity_dispatch_kimi_k2", "tokens":
           KIMI_TOKENS, "top_k": KIMI_TOP_K, "experts": e, "n": m,
           "capacity": cap, "dropped": int((~got.kept).sum()),
           "largest_expert": int(cnt.max()), "equal": True,
           "census": {"histogram": counts["histogram"],
                      "fused_pass": counts["fused_pass"]}, "ms": ms}
    emit(res)
    return res


def s2_phase(torch, np, log2n, reps, dev):
    """Slice S2 on the card, each case its own counted run: the LSD sorts,
    the partitions, ``capacity_dispatch``; returns the kernel rows' numbers
    and the S2 launches, per path (``lsd``, ``partition``: the partitions
    and the dispatch) and in all."""
    launches = {g: {"histogram": 0, "fused_pass": 0}
                for g in ("lsd", "partition", "partition_wide", "all")}

    def count(groups, got):
        for g in groups + ("all",):
            for k in ("histogram", "fused_pass"):
                launches[g][k] += got[k]

    lsd = {}
    for label, dtype, d, with_values, below, kpbs in LSD_CASES:
        res = lsd_case(torch, np, label, getattr(np, dtype), d, with_values,
                       1 << (log2n - below), kpbs, reps, dev)
        count(("lsd",), res["launches"])
        lsd[label] = res
        torch.cuda.empty_cache()
    parts = {}
    hist = None
    for label, buckets, kind, check_pass in PARTITION_CASES:
        res = partition_case(torch, np, label, buckets, kind, check_pass,
                             1 << log2n, reps, dev)
        count(("partition_wide",) if buckets > 512 else ("partition",),
              res["launches"])
        if label == "uniform_384":
            hist = check_histogram_s2(torch, res["ids"], 9, reps)
        del res["ids"]
        parts[label] = res
        torch.cuda.empty_cache()
    dispatch = dispatch_case(torch, reps, dev)
    count(("partition",), dispatch["census"])
    emit({"phase": "s2_summary", "launches": launches,
          "lsd_ms": {k: v["by_kpb"] for k, v in lsd.items()},
          "partition_ms": {k: v["ms"] for k, v in parts.items()},
          "capacity_dispatch_ms": dispatch["ms"]})
    return dict(lsd=lsd, parts=parts, histogram=hist, launches=launches)


# --------------------------------------------------------------------------
# phase 5: the out-of-core sort (paper §5) and its merge kernel
# --------------------------------------------------------------------------

#: the ooc phases' plan: 4 runs of 2^28 keys at full size, one merge round
OOC_KWAY = 4
OOC_TILE = 4096


def host_memory():
    """Total and available host RAM (bytes) from ``os.sysconf``."""
    page = os.sysconf("SC_PAGE_SIZE")
    res = {"phase": "host", "total_bytes": page * os.sysconf("SC_PHYS_PAGES"),
           "available_bytes": page * os.sysconf("SC_AVPHYS_PAGES"),
           "cpus": os.cpu_count()}
    emit(res)
    return res


def link_rates(torch, reps):
    """Pinned host <-> device copy rates (bytes/s), one 1 GiB copy each way,
    and the host copy rate into pinned memory (host clock); medians of
    ``reps`` after a warm-up."""
    nbytes = 1 << 30
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.fill_(1)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), reps)
    d2h = cuda_ms(torch, lambda: host.copy_(dev, non_blocking=True), reps)
    # the host side of the staging: one torch CPU copy, pageable -> pinned
    page = torch.empty(nbytes, dtype=torch.uint8)
    page.fill_(2)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        host.copy_(page)
        times.append((time.perf_counter() - t0) * 1e3)
    copy_ms = statistics.median(times[1:])
    res = {"phase": "link", "bytes": nbytes, "h2d_ms": h2d, "d2h_ms": d2h,
           "h2d_bytes_per_s": nbytes / (h2d / 1e3),
           "d2h_bytes_per_s": nbytes / (d2h / 1e3),
           "host_copy_ms": copy_ms,
           "host_copy_bytes_per_s": nbytes / (copy_ms / 1e3)}
    emit(res)
    del host, dev, page
    return res


def ooc_input(np, log2n):
    """The ooc phases' input from a seed: 2^(log2n + 2) uint32 keys with an
    int32 index value (8-byte records, the paper's record shape)."""
    n = 1 << (log2n + 2)
    keys = np.random.default_rng(1611).integers(0, 2**32, n, dtype=np.uint32)
    return keys, np.arange(n, dtype=np.int32)


def check_sorted(torch, label, keys, out_k, out_v):
    """Keys byte-equal to ``torch.sort(stable=True)`` of the carrier on the
    card, values equal to its stable indices."""
    import numpy as np
    from repro_torch.core import bijection
    dev = torch.device("cuda")
    kd = torch.from_numpy(keys.view(np.int32)).to(dev)
    s = torch.sort(bijection.sortable(kd), stable=True)
    del kd
    got = torch.from_numpy(out_k.view(np.int32)).to(dev)
    need(torch.equal(got, bijection.sortable(s.values)),
         f"{label}: keys differ from torch.sort")
    del got
    got = torch.from_numpy(out_v).to(dev)
    need(torch.equal(got.to(torch.int64), s.indices),
         f"{label}: values differ from torch.sort(stable=True) indices")
    del got, s
    torch.cuda.empty_cache()


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side event of a trace."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out.append((ev.name, ev.time_range.start, ev.time_range.end))
    return out


def _union(iv):
    merged = []
    for a, b in sorted(iv):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _measure(iv):
    return sum(b - a for a, b in iv)


def _intersect(x, y):
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_share(events):
    """The chunk phase's overlap of uploads and kernels: the window runs
    from the first host-to-device copy to the start of the first merge
    kernel; returns the shares of the window in which an H2D copy, a
    kernel, and both at once are active."""
    h2d = [(a, b) for n, a, b in events if n.startswith("Memcpy HtoD")]
    merges = [a for n, a, b in events if "kway_merge_kernel" in n]
    if not h2d or not merges:
        return None
    lo, hi = min(a for a, _ in h2d), min(merges)
    clip = lambda iv: _union([(max(a, lo), min(b, hi)) for a, b in iv
                              if min(b, hi) > max(a, lo)])
    kern = clip([(a, b) for n, a, b in events
                 if not n.startswith(("Memcpy", "Memset"))])
    up = clip(h2d)
    span = hi - lo
    merge_end = max(b for n, a, b in events if "kway_merge_kernel" in n)
    last = max(b for _, _, b in events)
    d2h_after = _union([(max(a, merge_end), b) for n, a, b in events
                        if n.startswith("Memcpy DtoH") and b > merge_end])
    return {"window_ms": span / 1e3, "h2d_share": _measure(up) / span,
            "kernel_share": _measure(kern) / span,
            "h2d_and_kernel_share": _measure(_intersect(up, kern)) / span,
            "trace_span_ms": (last - lo) / 1e3,
            "merge_kernel_ms": sum(b - a for n, a, b in events
                                   if "kway_merge_kernel" in n) / 1e3,
            "merge_start_to_merge_end_ms": (merge_end - hi) / 1e3,
            "after_merge_ms": (last - merge_end) / 1e3,
            "after_merge_d2h_ms": _measure(d2h_after) / 1e3}


def merge_check(torch, np, keys, vals, chunk, reps):
    """The merge kernel against its plain version on the tables of a real
    round: ``oocsort`` of the ooc phases' input under ``torch.profiler``,
    with ``outofcore.merge_round`` wrapped to keep clones of its inputs.
    Returns the check's numbers and the chunk phase's overlap shares."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import oocsort
    from repro_torch.core import bijection, outofcore
    from repro_torch.kernels import merge, ref
    rec = {}
    orig = outofcore.merge_round

    def hook(src_keys, src_vals, alt_keys, alt_vals, *, lens, kway, tile, n):
        if not rec:
            rec.update(keys=src_keys.clone(),
                       vals=tuple(v.clone() for v in src_vals),
                       tables=merge.merge_path_partition(src_keys, lens,
                                                         kway, tile),
                       lens=lens, kway=kway, tile=tile, n=n)
        return orig(src_keys, src_vals, alt_keys, alt_vals, lens=lens,
                    kway=kway, tile=tile, n=n)

    outofcore.merge_round = hook
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            oocsort(keys, chunk, values=vals, kway=OOC_KWAY, tile=OOC_TILE)
            torch.cuda.synchronize()
    finally:
        outofcore.merge_round = orig
    overlap = overlap_share(_device_intervals(prof))
    del prof
    need(rec, "the ooc run made no merge round")
    ck, cv, tables = rec["keys"], rec["vals"], rec["tables"]
    kway, tile, n = rec["kway"], rec["tile"], rec["n"]
    kw = dict(kway=kway, tpb=tile, n=n)

    def fresh():
        return torch.empty_like(ck), tuple(torch.empty_like(v) for v in cv)

    got_k, got_v = merge.kway_merge_round(ck, cv, *fresh(), *tables, **kw)
    want_k, want_v = ref.kway_merge_round_ref(ck, cv, *fresh(), *tables,
                                              **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(got_k[:n], want_k[:n])] +
                      [(a[:n], b[:n]) for a, b in zip(got_v, want_v)])
    need(err == 0, "merge kernel != plain version")
    equal_bytes = bool(torch.equal(got_k[:n], want_k[:n]) and all(
        torch.equal(a[:n], b[:n]) for a, b in zip(got_v, want_v)))
    need(equal_bytes, "merge kernel != plain version (bytes)")
    del want_k, want_v
    alt = fresh()
    ms = cuda_ms(torch, lambda: merge.kway_merge_round(ck, cv, *alt, *tables,
                                                       **kw), reps)
    plain = cuda_ms(torch, lambda: ref.kway_merge_round_ref(
        ck, cv, *alt, *tables, **kw), 1)
    del alt, got_k, got_v
    torch.cuda.empty_cache()
    # the same round at oocsort's default tile of 256 (4 M output tiles):
    # equal to the plain version, then timed
    small = merge.merge_path_partition(ck, rec["lens"], kway, 256)
    kw256 = dict(kway=kway, tpb=256, n=n)
    got_k, got_v = merge.kway_merge_round(ck, cv, *fresh(), *small, **kw256)
    want_k, want_v = ref.kway_merge_round_ref(ck, cv, *fresh(), *small,
                                              **kw256)
    torch.cuda.synchronize()
    err256 = max_abs_err(torch, [(got_k[:n], want_k[:n])] +
                         [(a[:n], b[:n]) for a, b in zip(got_v, want_v)])
    need(err256 == 0, "merge kernel (tile 256) != plain version")
    del got_k, got_v, want_k, want_v
    alt = fresh()
    ms256 = cuda_ms(torch, lambda: merge.kway_merge_round(
        ck, cv, *alt, *small, **kw256), reps)
    del alt
    torch.cuda.empty_cache()
    srt = bijection.sortable(ck[:n])
    lib = cuda_ms(torch, lambda: torch.sort(srt, stable=True), reps)
    del srt
    n_pad = ck.numel()
    kb, vb = ck.element_size(), sum(v.element_size() for v in cv)
    table_bytes = sum(t.numel() * 4 for t in tables)
    res = {"phase": "merge_check", "n": n, "n_pad": n_pad,
           "runs": len(rec["lens"]), "kway": kway, "tile": tile,
           "tiles": tables[0].numel(), "values": len(cv), "equal": True,
           "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "torch_sort_stable_ms": lib,
           "bound_bytes": 2 * n_pad * (kb + vb) + table_bytes,
           "bound_ms": bound_ms(2 * n_pad * (kb + vb) + table_bytes),
           "tile256": {"tiles": small[0].numel(), "equal": True,
                       "max_abs_err": err256, "ms": ms256,
                       "bound_ms": bound_ms(2 * n_pad * (kb + vb) + sum(
                           t.numel() * 4 for t in small))}}
    del small
    emit(res)
    del ck, cv, tables, rec
    torch.cuda.empty_cache()
    return res, overlap


def incore_yardstick(torch, np, keys, vals):
    """Upload + ``torch.sort(stable=True)`` + value gather + download of the
    same records, as a user with enough device memory would write it
    (pageable host arrays, ``.to`` / ``.cpu``): host clock, ending in a
    synchronize, with the three parts (a synchronize between them)."""
    from repro_torch.core import bijection
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kd = torch.from_numpy(keys.view(np.int32)).to(dev)
    vd = torch.from_numpy(vals).to(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = torch.sort(bijection.sortable(kd), stable=True)
    sk, sv = bijection.sortable(s.values), vd[s.indices]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out_k, out_v = sk.cpu(), sv.cpu()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del kd, vd, s, sk, sv, out_k, out_v
    torch.cuda.empty_cache()
    return {"ms": (t3 - t0) * 1e3, "upload_ms": (t1 - t0) * 1e3,
            "sort_ms": (t2 - t1) * 1e3, "download_ms": (t3 - t2) * 1e3}


def ooc_case(torch, np, label, keys, vals, chunk, rates, **kw):
    """One counted ``oocsort`` run: counts set to 0 just before it and read
    just after, host-clock wall time ending in a synchronize, peak device
    memory, then the equality checks against ``torch.sort``."""
    from repro_torch import oocsort
    from repro_torch.kernels import COUNTS, reset_counts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    out_k, out_v, st = oocsort(keys, chunk, values=vals, kway=OOC_KWAY,
                               tile=OOC_TILE, return_stats=True, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(COUNTS)
    peak = torch.cuda.max_memory_allocated() - base
    check_sorted(torch, label, keys, out_k, out_v)
    del out_k, out_v
    need(counts["fused_pass"] == st.chunk_passes_executed,
         f"{label}: fused launches {counts['fused_pass']} != "
         f"{st.chunk_passes_executed} executed chunk passes")
    need(st.h2d_bytes + st.d2h_bytes == st.chunk_link_bytes +
         st.spill_link_bytes + st.retry_link_bytes,
         f"{label}: link-byte identity broken")
    link_bound_s = max(st.h2d_bytes / rates["h2d_bytes_per_s"],
                       st.d2h_bytes / rates["d2h_bytes_per_s"])
    res = {"phase": label, "n": int(keys.size), "chunk_elems": chunk,
           "kway": OOC_KWAY, "tile": OOC_TILE, "equal": True,
           "stats": st._asdict(), "launches": counts, "wall_ms": wall,
           "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
           "link_bound_ms": link_bound_s * 1e3,
           "peak_mem_bytes": peak,
           "host_peak_rss_bytes":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           **kw}
    return res, st, counts


def spill_strips(n, nominal, st, kway, tile):
    """Strips (= merge launches) of a spill run, replayed from its plan: the
    input cut into ``nominal`` chunks, each re-split to the clamped
    ``st.chunk_elems``, then per round one strip per slab of whole tiles of
    every multi-run group."""
    from repro_torch.kernels.merge import merge_groups
    lens = []
    for o in range(0, n, nominal):
        m = min(nominal, n - o)
        lens += [min(st.chunk_elems, m - p)
                 for p in range(0, m, st.chunk_elems)]
    per_strip = st.spill_slab_elems // tile
    strips = 0
    while len(lens) > 1:
        for grp in merge_groups(lens, kway):
            if len(grp) > 1:
                strips += -(-(-(-sum(grp) // tile)) // per_strip)
        lens = [sum(g) for g in merge_groups(lens, kway)]
    return strips


def ooc_phases(torch, np, log2n, reps):
    """The ooc and ooc_spill phases and the merge check, on one input."""
    host_memory()
    rates = link_rates(torch, reps)
    keys, vals = ooc_input(np, log2n)
    chunk = 1 << log2n
    merge_res, overlap = merge_check(torch, np, keys, vals, chunk, reps)

    res, st, counts = ooc_case(torch, np, "ooc", keys, vals, chunk, rates)
    need(st.num_chunks == 4 and st.merge_rounds == 1,
         f"ooc: {st.num_chunks} runs / {st.merge_rounds} rounds, expected "
         f"the (4, 0) plan of 4 runs and 1 round")
    need(counts["merge"] == st.merge_rounds,
         f"ooc: merge launches {counts['merge']} != {st.merge_rounds} rounds")
    yard = incore_yardstick(torch, np, keys, vals)
    res["incore_yardstick_ms"] = yard.pop("ms")
    res["incore_yardstick_parts"] = yard
    res["chunk_phase_overlap"] = overlap
    emit(res)
    ooc_counts = counts

    # the budget's clamp sizes the chunks: ask for the whole input as one
    # chunk and let it cut runs of ~238.6 M keys (5 runs, 2 spilled rounds)
    budget = 1 << (log2n + 6)
    res, st, counts = ooc_case(torch, np, "ooc_spill", keys, vals, keys.size,
                               rates, spill_budget_bytes=budget)
    strips = spill_strips(keys.size, keys.size, st, OOC_KWAY, OOC_TILE)
    need(st.num_chunks == 5 and st.rounds_spilled == 2,
         f"ooc_spill: {st.num_chunks} runs / {st.rounds_spilled} spilled "
         f"rounds, expected 5 and 2")
    need(st.rounds_spilled >= 1, "ooc_spill: no round spilled")
    need(st.device_high_water_bytes <= budget,
         f"ooc_spill: modeled high water {st.device_high_water_bytes} > "
         f"budget {budget}")
    need(counts["merge"] == strips,
         f"ooc_spill: merge launches {counts['merge']} != {strips} strips")
    res.update(strips=strips, budget_bytes=budget,
               peak_over_budget=res["peak_mem_bytes"] / budget)
    emit(res)
    return merge_res, ooc_counts


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch  # noqa: F401  (fails without the repository's src/)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    environment(torch)
    build()

    # phase 3: kernels against their plain versions at main-path shapes
    n = 1 << args.log2n
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    hist = check_histogram(torch, keys, 6912, args.reps)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    rec_kv = capture(torch, keys, vals)
    fused_res = [check_fused(torch, r, n, f"kv_pass{i}", args.reps)
                 for i, r in enumerate(rec_kv["passes"])]
    merge_res = check_merge_rows(torch, rec_kv["merge"][0], args.reps)
    local_res = check_local_sort(torch, rec_kv, args.reps, "kv")
    del rec_kv
    rec_k = capture(torch, keys, None)
    check_local_sort(torch, rec_k, args.reps, "keys")
    for i, r in enumerate(rec_k["passes"]):
        check_fused(torch, r, n, f"keys_pass{i}", args.reps)
        plain = dict(r, kw=dict(r["kw"], lookahead=False))
        check_fused(torch, plain, n, f"keys_pass{i}_no_lookahead", 1)
    del rec_k, keys, vals
    torch.cuda.empty_cache()
    # the skewed capture: AND-3 keys (4 passes, long digit runs, rows of
    # later passes starting unaligned)
    and3 = rng.integers(0, 2**32, n, dtype=np.uint32)
    for _ in range(3):
        and3 &= rng.integers(0, 2**32, n, dtype=np.uint32)
    rec_a = capture(torch, torch.from_numpy(and3).to(dev), None, passes=4)
    del and3
    need(len(rec_a["passes"]) == 4,
         f"AND-3 ran {len(rec_a['passes'])} passes, expected 4")
    fused_and3 = [check_fused(torch, r, n, f"and3_pass{i}", args.reps)
                  for i, r in enumerate(rec_a["passes"])]
    need(any(r["unaligned_rows"] for r in fused_and3),
         "no fused pass with unaligned rows was checked")
    del rec_a
    torch.cuda.empty_cache()

    # library phase: the library-surface kernels (their own counted run)
    lib_res, lib_counts = library_phase(torch, np, args.log2n, args.reps, dev)

    # phase 4: the main path, counted
    cases = []
    for label, k, with_values in make_cases(torch, np, args.log2n, dev):
        cases.append(main_case(torch, label, k, with_values, args.reps))
        del k
        torch.cuda.empty_cache()
    main = next(c for c in cases if c["case"] == "uint32_uniform_kv")
    prof_keys = torch.from_numpy(np.random.default_rng(2016).integers(
        0, 2**32, n, dtype=np.uint32)).to(dev)
    profile_case(torch, prof_keys, True)
    del prof_keys
    launches = main["launches"]
    need(all(launches[k] > 0 for k in ("histogram", "fused_pass",
                                       "local_sort", "merge_rows")),
         f"a kernel of the main path was not launched: {launches}")
    torch.cuda.empty_cache()

    # the main path at d = 9 (r = 512; its own counted run)
    d9, _ = d9_phase(torch, np, args.log2n, args.reps, dev)
    need(all(d9["launches"][k] > 0 for k in ("histogram", "fused_pass",
                                             "local_sort", "merge_rows")),
         f"a kernel of the d = 9 path was not launched: {d9['launches']}")
    torch.cuda.empty_cache()

    # the main path at wide digits (d = 12 and 16; their own counted runs)
    wide = wide_phase(torch, np, args.log2n, args.reps, dev)
    for d, res in wide.items():
        need(all(res["sort"]["launches"][k] > 0 for k in (
            "histogram", "fused_pass", "local_sort", "merge_rows")),
             f"a kernel of the d = {d} path was not launched: "
             f"{res['sort']['launches']}")

    # slice S2: the LSD sort and the single-pass partition (their own
    # counted runs)
    s2 = s2_phase(torch, np, args.log2n, args.reps, dev)
    need(all(v[k] > 0 for v in s2["launches"].values()
             for k in ("histogram", "fused_pass")),
         f"a kernel of the S2 path was not launched: {s2['launches']}")
    torch.cuda.empty_cache()

    # phase 5: the out-of-core path (its own counted runs)
    kmerge_res, ooc_launches = ooc_phases(torch, np, args.log2n, args.reps)
    need(all(ooc_launches[k] > 0 for k in ("histogram", "fused_pass",
                                           "local_sort", "merge")),
         f"a kernel of the ooc path was not launched: {ooc_launches}")

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="histogram", route="cuda", source=src + "histogram.cu",
             replaces="src/repro/kernels/histogram.py:28",
             launches=launches["histogram"], **_k(hist["uniform"]),
             bound_by="bytes", library_ms=hist["uniform"]["library_ms"]),
        dict(name="fused_pass", route="cuda", source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=launches["fused_pass"], **_k(fused_res[0]),
             bound_by="bytes", library_ms=None),
        dict(name="local_sort", route="cuda", source=src + "local_sort.cu",
             replaces="src/repro/kernels/bitonic.py:94",
             launches=launches["local_sort"], **_k(local_res),
             bound_by="bytes", library_ms=local_res["library_ms"]),
        dict(name="merge_rows", route="cuda", source=src + "merge_rows.cu",
             replaces="src/repro/core/plan.py:250",
             launches=launches["merge_rows"], **_k(merge_res),
             bound_by="bytes", library_ms=None),
        dict(name="merge", route="cuda", source=src + "merge.cu",
             replaces="src/repro/kernels/merge.py:313",
             launches=ooc_launches["merge"], **_k(kmerge_res),
             bound_by="bytes",
             library_ms=kmerge_res["torch_sort_stable_ms"]),
    ]
    w12, w16 = wide[12], wide[16]
    kernels += [
        dict(name="histogram_wide", route="cuda",
             source=src + "histogram.cu",
             replaces="src/repro/kernels/histogram.py:28",
             launches=w12["sort"]["launches"]["histogram"],
             **_k(w12["histogram"]), bound_by="bytes",
             library_ms=w12["histogram"]["library_ms"]),
        dict(name="fused_pass_wide", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=w12["sort"]["launches"]["fused_pass"],
             **_k(w12["passes"][0]), bound_by="bytes", library_ms=None),
        dict(name="fused_pass_wide_d16", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=w16["sort"]["launches"]["fused_pass"],
             **_k(w16["passes"][0]), bound_by="bytes", library_ms=None),
        dict(name="merge_rows_wide", route="cuda",
             source=src + "merge_rows.cu",
             replaces="src/repro/core/plan.py:250",
             launches=w16["sort"]["launches"]["merge_rows"],
             **_k(w16["merge_rows"]), bound_by="bytes", library_ms=None)]
    lsd_kv = s2["lsd"]["uint32_kv_d8"]["fused"]
    part = s2["parts"]["uniform_384"]["fused"]
    part_wide = s2["parts"]["uniform_65536"]["fused"]
    kernels += [
        dict(name="histogram_s2", route="cuda", source=src + "histogram.cu",
             replaces="src/repro/kernels/histogram.py:28",
             launches=s2["launches"]["all"]["histogram"],
             **_k(s2["histogram"]),
             bound_by="bytes", library_ms=s2["histogram"]["library_ms"]),
        dict(name="fused_pass_lsd", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=s2["launches"]["lsd"]["fused_pass"], **_k(lsd_kv),
             bound_by="bytes", library_ms=None),
        dict(name="fused_pass_partition", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=s2["launches"]["partition"]["fused_pass"], **_k(part),
             bound_by="bytes", library_ms=None),
        dict(name="fused_pass_partition_wide", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=s2["launches"]["partition_wide"]["fused_pass"],
             **_k(part_wide),
             bound_by="bytes", library_ms=None)]
    lib_src = {"bitonic_rows": ("bitonic_rows.cu", "bitonic.py:90"),
               "bitonic_rows_kv": ("bitonic_rows.cu", "bitonic.py:100"),
               "multisplit": ("multisplit.cu", "multisplit.py:87"),
               "multisplit_kv": ("multisplit.cu", "multisplit.py:98"),
               "assigned_hist": ("histogram.cu", "assigned.py:26")}
    for name, (cu, line) in lib_src.items():
        kernels.append(dict(
            name=name, route="cuda", source=src + cu,
            replaces="src/repro/kernels/" + line, launches=lib_counts[name],
            **_k(lib_res[name]),
            bound_by=lib_res[name].get("bound_by", "bytes"),
            library_ms=lib_res[name]["library_ms"]))
    emit({"phase": "summary", "main_path": "uint32_uniform_kv",
          "host_reads": launches["host_reads"], "sort_ms": main["ms"],
          "torch_sort_ms": main["torch_sort_ms"], "d9_sort_ms": d9["ms"],
          "d12_kv_sort_ms": wide[12]["sort"]["ms"],
          "d16_sort_ms": wide[16]["sort"]["ms"],
          "lsd_kv_d8_ms": s2["lsd"]["uint32_kv_d8"]["by_kpb"],
          "lsd_d5_ms": s2["lsd"]["uint32_d5"]["by_kpb"]})
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _k(res):
    return dict(max_abs_err=res["max_abs_err"], ms=res["ms"],
                plain_ms=res["plain_ms"], bound_ms=res["bound_ms"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28,
                        help="log2 of the largest key count (default 28)")
    parser.add_argument("--reps", type=int, default=3,
                        help="timed repetitions per measurement")
    args = parser.parse_args(argv)
    try:
        return run(args)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 3
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
