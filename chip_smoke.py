#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together) and drives ten paths of
the port, each with the launch counters set to 0 just before it and read
just after:

* the serving path (its ``serve`` phase, first, on an empty card):
  ``repro_torch.serve.ServeEngine`` serving Qwen3-30B-A3B at its full
  published config (48 layers, bf16, 61 GB of random weights from a seed)
  a queue of 16 requests (prompts of 16–48 tokens, 16 / 80 / 144 / 208 new
  tokens each four times) at batch 8 with a 320-row cache: the admission
  order against a stable sort of the length classes, the census (one
  histogram and one fused pass per ``schedule``, 48 + 48 per decode step,
  no host read in a step), every token in range; batch 0 again with the
  MoE dispatch on ``engine="argsort"``, every captured dispatch table and
  every token equal; the histogram and the fused pass held to their plain
  versions at the admission's (16 ids into 256 buckets) and the
  dispatch's (64 ids into 128 experts) shapes, beside ``torch.bincount``
  and ``torch.sort(stable=True)`` + ``torch.bincount``; each prefill and a
  decode step timed (CUDA events), decode tokens/s, the 48 dispatches of a
  step timed alone, one step's host spans and profiled device time, peak
  memory and the step's byte bound (the parameters one step reads at
  3.35 TB/s); the parameters freed before the next phase;

* the training path (its ``train`` phase, second, on an empty card):
  ``Trainer.run`` on Qwen3-30B-A3B at its full published width cut to 6
  layers (4.36 B parameters; bf16 weights and gradients, float32 AdamW
  moments: 52.3 GB of state from a seed), ``SyntheticLMData`` 8 x 4096
  tokens in 8 microbatches, remat on: first one sequence's forward and
  backward with the MoE dispatch on the kernels and on ``argsort`` (every
  table of the forward and of the recompute, the loss and every
  gradient's bits equal); then a warm-up step (lr 0: no parameter bit may
  change) and 3 timed steps (CUDA events), counted: 96 histograms and 96
  fused passes a step (6 layers x 8 microbatches, forward and recompute),
  no host read, loss and gradient norm finite, parameters changed; one
  profiled step (device busy, the dispatches' share); the histogram and
  the fused pass at the step's dispatch shape (32 768 ids into 128
  experts) against their plain versions, beside ``torch.bincount`` and
  ``torch.sort(stable=True)`` + ``torch.bincount``; peak memory; the state
  freed; then the smoke Qwen3 through ``Trainer`` on the card, 7 steps,
  resumed at its step-5 checkpoint for 5 more, bit-equal to a 10-step run;

* the launch path (its ``launch`` phase, last): Qwen3-30B-A3B at its full
  published width cut to 2 layers (1.87 B parameters, AdamW), one train
  step of 2 x 4096 ``SyntheticLMData`` tokens in 2 microbatches on a
  one-rank NCCL ``DeviceMesh`` (1, 1): parameters, optimizer state and
  batch DTensors placed by ``launch/sharding.py``, the MoE dispatch tables
  built under ``local_map`` (so the histogram and fused-pass kernels see
  the local tensors), held against the unsharded ``make_train_step`` on
  the same inputs: loss, gradient norm and every updated parameter bit for
  bit, the same histogram and fused-pass launches (8 + 8), each step timed
  again; ``compressed_psum`` over that group bit-equal to the int8 round
  trip; the histogram and the fused pass at the step's dispatch shape
  (4 096 x 8 ids into 128 experts) against their plain versions; and, in
  two processes of their own started first (their fake 256- / 512-rank
  groups must not meet the NCCL one), ``python -m
  repro_torch.launch.dryrun`` of
  Qwen3-30B-A3B's ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the
  ``pod`` and ``multipod`` meshes, each cell's row (GiB per chip, the
  three roofline terms reckoned with the H100's constants, the
  bottleneck, ``mfu_bound``, whether it fits 80 GB) on its own line, every
  cell required ``ok``;
* the user-facing entry points (its ``examples`` phase, after the launch
  path), each as a user runs it, at the reference's sizes:
  ``scripts/torch_smoke_sort.py`` (n from 0 to 20 000 and five key kinds
  with values at the small config, LSD; ``SMOKE OK``),
  ``examples/torch_quickstart.py`` (2^18 keys alone, with values and
  AND-skewed, 10^5 floats, ``lsd_sort`` at d = 5),
  ``examples/torch_distributed_sort.py`` (2^21 keys over ``LocalMesh(8)``:
  uniform, AND-3, 4 chunks, KV), ``examples/torch_serve_decode.py`` (10
  requests on the smoke InternLM2) and ``examples/torch_train_moe.py``
  (the 100M Qwen3-family MoE to step 100, then the same command to step
  200, resumed from its checkpoint in a temporary directory), each in
  this process with the counters at 0 and under the launch recorder:
  the CUDA kernels launched (histogram, fused pass and, for the sorts,
  the local sort), no plain version, every printed ``ok`` true; then
  ``scripts/torch_probe_multipod.py`` (in a process of its own, on the
  host: the 512-rank mesh over a fake group, ``PROBE OK``, each of the
  five collective kinds counted) and
  ``scripts/torch_make_experiments_tables.py`` on the launch path's
  dry-run artifacts (every ``ok`` cell once per table); the histogram
  and the fused pass held to their plain versions at the shapes these
  entries gave them (``serve_decode``'s admission partition of 10 ids,
  ``train_moe``'s first MoE dispatch), beside ``torch.bincount`` and
  ``torch.sort(stable=True)`` + ``torch.bincount``, as four rows of the
  kernels line; wall seconds, passes, exchange attempts and shard fill,
  batches and tokens, ``train_moe``'s losses and ms per step;
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
* slice S4 (its ``dist`` phase): ``make_distributed_sort`` over
  ``LocalMesh(8)`` on the card, 2^28 uint32 keys with int32 values (n_local
  2^25, slack 2) at 1 and 4 chunks on uniform, clustered (4 clusters) and
  Zipf(1.5) keys: the valid prefixes against ``torch.sort(stable=True)``,
  the values a permutation pairing each key, no overflow, one attempt,
  the census per launch site (chunk sorts, exchange partitions,
  compaction), no shard past 2·n/8 keys for uniform and clustered keys;
  the exchange's 8-bucket and the compaction's 2-bucket fused passes held
  to their plain versions on one shard's data; the whole sort and each
  stage timed (CUDA events) beside ``hybrid_sort`` and ``torch.sort`` of
  the same records, with peak memory and the reference's link bytes;
  smaller cases at 2^24 (int16 and float32 with ±0 / ±inf / NaN payloads
  with values, int64 at 2^23, a constant key, ``num_chunks > n_local``,
  the reference's adversarial retry converging at slack 1.2 and
  exhausting at 0.5); a one-rank NCCL ``ProcessGroupMesh`` on 2^26
  records byte-equal to ``LocalMesh(1)``; ``length_bucketed_batches`` on
  2^20 lengths by its host, ``ooc`` and ``dist`` routes, each a valid
  packing equal to the host route's;
* the contract layer (its ``analysis`` phase, before the launch path):
  ``repro_torch.analysis.run_all`` with the CUDA kernels (the reference's
  ten contracts and the descriptor tables, each run under the launch
  recorder, the sort counter and ``torch.profiler``, the first fused and
  merge launch replayed with an ``arange`` leaf) and the lint, then the
  main path at full size, 2^28 uint32 keys with int32 values at (4,0),
  counted and recorded: the census ``2 + classes`` with ``1 + passes +
  classes`` launches, each kernel's launches equal to the profiler's and
  to the counters, no sort op, the alternates written in place, the sweep
  bytes exactly ``(2p + 1)·n_pad·4 + 2p·n_pad·4``, the result equal to
  ``torch.sort(stable=True)``;
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
``--reps`` sets the timed repetitions; ``--only serve`` / ``--only
train`` / ``--only launch`` / ``--only analysis`` / ``--only examples``
runs that phase alone (``analysis`` and ``examples`` then hold the main
path's histogram, fused pass, local sort and ``merge_rows`` to their
plain versions for the kernels line; ``examples`` starts the dry run
whose artifacts the tables script reads itself).  None is needed for the full run, which runs every phase at
full size.
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


def check_histogram_s2(torch, ids, width, reps, kpb=1024,
                       label="partition_ids"):
    """The prologue histogram at a partition's shape (the ids padded as
    the single pass pads them at ``kpb``), against its plain version,
    timed beside ``torch.bincount``."""
    from repro_torch.kernels import fused, histogram, ref
    m = ids.numel()
    (ck, _), _ = fused.make_ping_pong(ids, (), kpb)
    err = max_abs_err(torch, [(histogram.digit_total(ck, m, 0, width),
                               ref.radix_histogram_ref(
                                   ck[:m].reshape(1, -1), 0, width)[0])])
    need(err == 0, f"histogram ({label}) != plain")
    res = dict(ms=cuda_ms(torch, lambda: histogram.digit_total(
        ck, m, 0, width), reps),
        plain_ms=cuda_ms(torch, lambda: ref.radix_histogram_ref(
            ck[:m].reshape(1, -1), 0, width), max(1, reps // 2)),
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            ids, minlength=1 << width), reps),
        bound_ms=bound_ms(m * 4 + (1 << width) * 4), max_abs_err=err)
    emit({"phase": "kernel_check", "kernel": "histogram", "keys": label,
          "n": m, "width": width, "equal": True, **res})
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
# slice S4: the distributed sample sort on a local shard mesh
# --------------------------------------------------------------------------

#: the distributed sort's main case: 2^log2n uint32 keys with int32 values
#: (the main path's 2 GiB of 8-byte records) over 8 shards on the card
DIST_SHARDS = 8
#: each stage is one function of ``core.distributed``, timed by events
DIST_STAGES = (("local_sorts", "_sort_chunk"),
               ("splitters", "_local_sample"),
               ("splitters", "_make_splitters"),
               ("dest_shards", "_dest_shards"),
               ("exchange_partitions", "_pack"),
               ("merge", "_merge_runs"),
               ("compaction", "_compact"))
#: the launch sites counted apart in a counted run
DIST_SITES = (("chunk_sorts", "_sort_chunk"), ("exchange", "_pack"),
              ("compaction", "_compact"))


def dist_keys(np, kind, n, nshards):
    """uint32 keys from ``repro_torch.data``: uniform and Zipf(1.5) drawn
    per shard from its own seed, in threads (numpy's generators release
    the GIL while they draw); clustered (4 clusters) in one call, so every
    shard draws around the same 4 centres."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.data import clustered_keys, entropy_keys, zipf_keys
    if kind == "clustered":
        return clustered_keys(2020, n, clusters=4)
    per = n // nshards

    def one(s):
        if kind == "uniform":
            return entropy_keys(2021 + s, per, 0)
        return zipf_keys(2041 + s, per, a=1.5)

    with ThreadPoolExecutor(nshards) as pool:
        return np.concatenate(list(pool.map(one, range(nshards))))


def _patched(module, attrs, wrap):
    """Replace ``module.<attr>`` by ``wrap(name, original)`` for each
    (name, attr); returns the originals, for ``_restore``."""
    saved = {}
    for name, attr in attrs:
        saved.setdefault(attr, getattr(module, attr))
        setattr(module, attr, wrap(name, saved[attr]))
    return saved


def _restore(module, saved):
    for attr, fn in saved.items():
        setattr(module, attr, fn)


def dist_counted(torch, keys, vals, nshards, chunks, **knobs):
    """One counted distributed sort over ``LocalMesh(nshards)``: the
    output, the launch counts, the launches of each site (chunk sorts,
    exchange partitions, compaction; the wrappers only read the counters
    around the calls) and the peak of allocated memory."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import COUNTS, reset_counts
    sites = {name: dict.fromkeys(COUNTS, 0) for name, _ in DIST_SITES}

    def wrap(name, fn):
        def inner(*a, **k):
            before = dict(COUNTS)
            out = fn(*a, **k)
            for key, v in COUNTS.items():
                sites[name][key] += v - before[key]
            return out
        return inner

    fn = D.make_distributed_sort(D.LocalMesh(nshards), num_chunks=chunks,
                                 **knobs)
    saved = _patched(D, DIST_SITES, wrap)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        out = fn(keys, vals) if vals is not None else fn(keys)
        torch.cuda.synchronize()
        counts = dict(COUNTS)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        _restore(D, saved)
    return out, counts, sites, peak


def dist_check(torch, label, keys, vals, out, exhausted=False):
    """The valid prefixes against ``torch.sort(stable=True)`` of the
    ordered-bits carrier, the values a permutation that pairs each key;
    an exhausted retry's clipped prefixes are only checked sorted and
    paired."""
    from repro_torch.core import bijection
    from repro_torch.core.distributed import valid_concat
    stats = out[-1]
    got = valid_concat(out[0], stats.valid)
    if exhausted:
        s = bijection.sortable(bijection.to_ordered_bits(got))
        need(bool((s[1:] >= s[:-1]).all()),
             f"dist {label}: clipped output not sorted")
    else:
        ref_k, _ = reference_sort(torch, keys)
        need(same_bits(torch, got, ref_k),
             f"dist {label}: keys differ from torch.sort(stable=True)")
        del ref_k
    if vals is not None:
        idx = valid_concat(out[1], stats.valid).to(torch.int64)
        if not exhausted:
            need(torch.equal(torch.sort(idx).values,
                             torch.arange(keys.numel(), device=idx.device)),
                 f"dist {label}: values are not a permutation")
        # gathered through the carrier: CUDA has no uint32 gather
        need(torch.equal(bijection.to_ordered_bits(keys)[idx],
                         bijection.to_ordered_bits(got)),
             f"dist {label}: keys[values] != keys")


def dist_census(torch, label, keys, counts, sites, stats, nshards, chunks,
                cfg=None):
    """Per shard C·(1 + A) + 1 histograms, the chunk sorts' executed
    passes + C·A + 1 fused passes (the passes recounted by sorting each
    chunk again with ``return_stats``), at most C·classes local sorts;
    each site's own share as well."""
    from repro_torch.core import bijection, hybrid, model
    from repro_torch.core.distributed import _UNSIGNED
    P, C = nshards, chunks
    A = int(stats.exchange_attempts[0])
    n_local = keys.numel() // P
    chunk = n_local // C
    if chunk == 0:
        need(A == 0 and counts["histogram"] == counts["fused_pass"] == 0,
             f"dist {label}: degenerate census {counts}")
        return dict(attempts=0, passes=0)
    cfg = cfg or model.default_config(keys.element_size())
    carrier = bijection.to_ordered_bits(keys)
    passes = 0
    for c in range(P * C):
        part = carrier[c * chunk:(c + 1) * chunk].view(_UNSIGNED[
            carrier.dtype])
        passes += hybrid.hybrid_sort(part, cfg=cfg, return_stats=True,
                                     narrow=False)[1].counting_passes
    classes = len(hybrid.local_sort_classes(chunk, cfg))
    want = {("chunk_sorts", "histogram"): P * C,
            ("chunk_sorts", "fused_pass"): passes,
            ("exchange", "histogram"): P * C * A,
            ("exchange", "fused_pass"): P * C * A,
            ("compaction", "histogram"): P,
            ("compaction", "fused_pass"): P}
    for (site, kernel), v in want.items():
        need(sites[site][kernel] == v, f"dist {label}: {site} {kernel} "
             f"launches {sites[site][kernel]} != {v}")
    need(counts["histogram"] == P * (C * (1 + A) + 1) and
         counts["fused_pass"] == passes + P * (C * A + 1) and
         counts["local_sort"] <= P * C * classes,
         f"dist {label}: census {counts} (A = {A}, passes {passes}, "
         f"classes {classes})")
    return dict(attempts=A, passes=passes, classes=classes)


def link_bytes(P, C, A, n_local, kb, vb, oversample=64, refine=4,
               slack=2.0):
    """Bytes that would cross links between shards, by the reference's
    ``link_bytes`` formula (``repro.core.distributed.ANALYSIS_CONTRACT``):
    per attempt per chunk the keys, values and counts at capacity padding,
    the splitter samples, the overflow flags; the (P - 1) / P share that
    leaves a shard."""
    import math
    chunk = n_local // C
    base = slack * chunk / P
    cap = max(1, min(chunk, int(base + 4.0 * math.sqrt(max(base, 1.0)))))
    samp = [C * max(1, min(-(-oversample * refine ** a // C), chunk))
            for a in range(A)]
    return int((P - 1) / P * (A * C * P * (cap * (kb + vb) + 4) +
                              kb * P * sum(samp) + A * 2 * 4))


def dist_case(torch, label, keys, vals, nshards, chunks, gate=None,
              exhausted=False, **knobs):
    """One counted run, checked for order, pairing, census, overflow and
    attempts; returns its record (with the counts and sites).  With fewer
    keys a shard than chunks nothing is exchanged: every output is the
    sentinel (the carrier's -1) and no shard is valid."""
    from repro_torch.core import bijection
    out, counts, sites, peak = dist_counted(torch, keys, vals, nshards,
                                            chunks, **knobs)
    stats = out[-1]
    if keys.numel() // nshards < chunks:
        need(bool((bijection.to_ordered_bits(out[0]) == -1).all()) and
             not stats.valid.any(), f"dist {label}: not an empty exchange")
    else:
        dist_check(torch, label, keys, vals, out, exhausted)
    census = dist_census(torch, label, keys, counts, sites, stats, nshards,
                         chunks)
    valid = stats.valid.tolist()
    over = bool(stats.overflow.any())
    if exhausted:
        need(over and census["attempts"] == knobs.get("max_attempts", 3) and
             sum(valid) < keys.numel(),
             f"dist {label}: expected an exhausted retry, got {stats}")
    else:
        need(not over, f"dist {label}: residual overflow")
    if gate is not None:
        need(max(valid) <= gate, f"dist {label}: a shard received "
             f"{max(valid)} > {gate} keys (the ≤ 2x gate)")
    res = {"phase": "dist", "case": label, "n": keys.numel(),
           "dtype": str(keys.dtype).replace("torch.", ""),
           "values": vals is not None, "shards": nshards, "chunks": chunks,
           "knobs": knobs, "equal": True,
           "exchange_attempts": census["attempts"], "overflow": over,
           "valid": valid, "valid_max": max(valid), "gate": gate,
           "peak_recv": stats.peak_recv.tolist(), "census": counts,
           "sites": {k: {c: v[c] for c in ("histogram", "fused_pass")}
                     for k, v in sites.items()},
           "chunk_passes": census["passes"], "peak_mem_bytes": peak,
           "link_bytes": link_bytes(
               nshards, chunks, census["attempts"], keys.numel() // nshards,
               keys.element_size(),
               vals.element_size() if vals is not None else 0,
               **{k: v for k, v in knobs.items()
                  if k in ("oversample", "slack")}) if census["attempts"]
           else 0}
    emit(res)
    return dict(res, launches=counts, site_counts=sites)


def dist_stages(torch, keys, vals, nshards, chunks):
    """One sort with each stage function wrapped in CUDA events (and the
    mesh's all-to-all copies): milliseconds per stage, summed over its
    calls, and the run's own events."""
    from repro_torch.core import distributed as D
    events = {}

    def wrap(name, fn):
        def inner(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.setdefault(name, []).append((start, end))
            return out
        return inner

    mesh = D.LocalMesh(nshards)
    mesh.all_to_all = wrap("all_to_all_copies", mesh.all_to_all)
    fn = D.make_distributed_sort(mesh, num_chunks=chunks)
    fn(keys, vals)                                   # warm-up
    events.clear()
    saved = _patched(D, DIST_STAGES, wrap)
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(keys, vals)
        end.record()
        end.synchronize()
    finally:
        _restore(D, saved)
    stages = {name: sum(s.elapsed_time(e) for s, e in evs)
              for name, evs in events.items()}
    return dict(stages_ms=stages, run_ms=start.elapsed_time(end),
                calls={name: len(evs) for name, evs in events.items()})


def dist_partition_ids(torch, keys, vals, nshards):
    """The ids of the first exchange partition (shard 0's first chunk,
    ``nshards`` buckets) and of the first compaction (shard 0, 2 buckets)
    of an uncounted run."""
    from repro_torch.core import distributed as D
    rec = {}
    orig = D.counting_partition

    def hook(ids, num_buckets, engine=None):
        rec.setdefault(num_buckets, ids.clone())
        return orig(ids, num_buckets, engine=engine)

    D.counting_partition = hook
    try:
        D.make_distributed_sort(D.LocalMesh(nshards))(keys, vals)
    finally:
        D.counting_partition = orig
    torch.cuda.synchronize()
    return rec[nshards], rec[2]


def dist_kernels(torch, keys, vals, nshards, reps):
    """The fused pass of the 8-bucket exchange partition and of the
    2-bucket compaction, on one shard's data at full size, against their
    plain versions."""
    from repro_torch.core import segmented
    ex_ids, cp_ids = dist_partition_ids(torch, keys, vals, nshards)
    res = {}
    for label, ids, buckets in (("exchange", ex_ids, nshards),
                                ("compaction", cp_ids, 2)):
        rec = first_pass(torch, lambda: segmented.counting_partition(
            ids, buckets))
        res[label] = check_fused(torch, rec, ids.numel(),
                                 f"dist_{label}_{buckets}", reps)
        del rec
        torch.cuda.empty_cache()
    return res


def dist_small_keys(np, kind, n):
    """The smaller cases' keys, from seeds."""
    rng = np.random.default_rng(2050)
    if kind == "int16":
        return rng.integers(-2**15, 2**15, n).astype(np.int16)
    if kind == "int64":
        return rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                            endpoint=True)
    if kind == "float32":
        x = rng.standard_normal(n).astype(np.float32)
        pick = rng.integers(0, n, n // 64)
        x[pick] = np.array([0.0, -0.0, np.inf, -np.inf],
                           np.float32)[np.arange(pick.size) % 4]
        nan = rng.integers(0, n, n // 256)
        bits = x.view(np.uint32)
        # NaNs of both signs with random payloads
        bits[nan] = (np.uint32(0x7F800000) | rng.integers(
            1, 1 << 23, nan.size, dtype=np.uint32) |
            (rng.integers(0, 2, nan.size, dtype=np.uint32) << np.uint32(31)))
        return x
    if kind == "constant":
        return np.full(n, 42, np.uint32)
    # the reference's adversarial retry input (RETRY_BODY of
    # tests/test_distributed_property.py) at n keys
    base = rng.integers(0, 2**32 - 1, n, dtype=np.uint32, endpoint=True)
    cl = (0x80000000 + rng.integers(0, 1 << 16, n, dtype=np.uint32))
    return np.where(rng.random(n) < 0.95, cl, base).astype(np.uint32)


#: the smaller cases: (label, keys, log2n below the main case, values,
#: chunks, knobs); the retry input converges in more than one attempt at
#: oversample 2 / slack 1.2 and exhausts 3 attempts at slack 0.5
DIST_SMALL = (("int16_kv", "int16", 4, True, 2, {}),
              ("float32_special_kv", "float32", 4, True, 1, {}),
              ("int64_kv", "int64", 5, True, 1, {}),
              ("constant_kv", "constant", 4, True, 4, {}),
              ("retry_converges", "retry", 4, False, 1,
               dict(oversample=2, slack=1.2)),
              ("retry_exhausts", "retry", 4, False, 1,
               dict(oversample=2, slack=0.5)))


def dist_nccl(torch, np, n, reps, dev):
    """A one-rank NCCL group (an in-process store, ``device_id`` the card):
    the process-group mesh's result byte-equal to ``LocalMesh(1)``'s,
    stats included, and both timed."""
    import torch.distributed as dist
    from repro_torch.core.distributed import (LocalMesh, ProcessGroupMesh,
                                              make_distributed_sort)
    from repro_torch.data import entropy_keys
    keys = torch.from_numpy(entropy_keys(2060, n, 0)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = ProcessGroupMesh()
        need(mesh.device == dev, f"NCCL mesh on {mesh.device}")
        pg = make_distributed_sort(mesh)
        local = make_distributed_sort(LocalMesh(1))
        got, want = pg(keys, vals), local(keys, vals)
        torch.cuda.synchronize()
        need(same_bits(torch, got[0], want[0]) and
             torch.equal(got[1], want[1]),
             "NCCL world-1 mesh: output differs from LocalMesh(1)")
        for f in got[2]._fields:
            need(torch.equal(getattr(got[2], f), getattr(want[2], f)),
                 f"NCCL world-1 mesh: stats.{f} differs from LocalMesh(1)")
        dist_check(torch, "nccl_world1", keys, vals, got)
        res = {"phase": "dist_nccl", "n": n, "backend": mesh.backend,
               "world_size": mesh.size, "equal_to_local_mesh": True,
               "valid": got[2].valid.tolist(),
               "ms": cuda_ms(torch, lambda: pg(keys, vals), reps),
               "local_mesh_ms": cuda_ms(torch, lambda: local(keys, vals),
                                        reps)}
    finally:
        dist.destroy_process_group()
    emit(res)
    return res


def bucketing_routes(torch, np, m, ooc_chunk):
    """``length_bucketed_batches`` on m document lengths below 2^16 by
    its three routes (host LSD, ``ooc``, ``dist`` over ``LocalMesh(8)``),
    each timed on the host clock, checked as a valid packing and against
    the host route's lengths and bounds."""
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.data import length_bucketed_batches
    from repro_torch.kernels import COUNTS, reset_counts
    lengths = np.random.default_rng(2070).integers(
        1, 1 << 16, m).astype(np.uint32)
    batch = 1 << 20
    routes = (("host", {}), ("ooc", dict(ooc_chunk_elems=ooc_chunk)),
              ("dist", dict(dist_mesh=LocalMesh(DIST_SHARDS))))
    res, first = {}, None
    for name, kw in routes:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        order, bounds = length_bucketed_batches(lengths, batch, **kw)
        seconds = time.perf_counter() - t0
        counts = dict(COUNTS)
        sl = lengths[order].astype(np.int64)
        b = np.asarray(bounds, np.int64)
        need(np.array_equal(np.sort(order), np.arange(m)) and
             bool((np.diff(sl) >= 0).all()) and
             bool((sl[b[1:] - 1] * np.diff(b) <= batch).all()),
             f"bucketing {name}: not a valid packing")
        if first is None:
            first = (sl, bounds)
        need(np.array_equal(sl, first[0]) and bounds == first[1],
             f"bucketing {name}: lengths or bounds differ from the host "
             f"route's")
        res[name] = dict(seconds=seconds, batches=len(bounds) - 1,
                         launches={k: counts[k] for k in (
                             "histogram", "fused_pass", "local_sort",
                             "merge") if counts[k]})
    emit({"phase": "bucketing", "docs": m, "batch_tokens": batch,
          "ooc_chunk_elems": ooc_chunk, "equal": True, "routes": res})
    return res


def dist_phase(torch, np, log2n, reps, dev):
    """Slice S4 on the card, each case its own counted run: the main case
    (uniform, clustered, Zipf keys with values at 1 and 4 chunks), its
    kernels against their plain versions, its times; the smaller cases;
    the NCCL world-1 mesh; length bucketing's three routes."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import hybrid_sort
    from repro_torch.core import distributed as D
    n = 1 << log2n
    P = DIST_SHARDS
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    main, times, kernels = {}, {}, None
    with ThreadPoolExecutor(2) as pool:
        later = {kind: pool.submit(dist_keys, np, kind, n, P)
                 for kind in ("clustered", "zipf")}
        for kind in ("uniform", "clustered", "zipf"):
            x = (dist_keys(np, kind, n, P) if kind == "uniform"
                 else later[kind].result())
            keys = torch.from_numpy(x).to(dev)
            del x
            gate = 2 * n // P if kind != "zipf" else None
            for chunks in (1, 4):
                label = f"{kind}_kv_c{chunks}"
                main[label] = dist_case(torch, label, keys, vals, P, chunks,
                                        gate=gate)
                torch.cuda.empty_cache()
            if kind == "uniform":
                kernels = dist_kernels(torch, keys, vals, P, reps)
                for chunks in (1, 4):
                    fn = D.make_distributed_sort(D.LocalMesh(P),
                                                 num_chunks=chunks)
                    times[chunks] = dict(
                        ms=cuda_ms(torch, lambda: fn(keys, vals), reps),
                        **dist_stages(torch, keys, vals, P, chunks))
                    torch.cuda.empty_cache()
                lib_keys = keys.view(torch.int32)
                times["hybrid_sort_same_records_ms"] = cuda_ms(
                    torch, lambda: hybrid_sort(keys, vals), reps)
                times["torch_sort_same_records_ms"] = cuda_ms(
                    torch, lambda: torch.sort(lib_keys, stable=True), reps)
                emit({"phase": "dist_times", "n": n, "shards": P,
                      **{f"chunks_{c}": times[c] for c in (1, 4)},
                      "hybrid_sort_same_records_ms":
                      times["hybrid_sort_same_records_ms"],
                      "torch_sort_same_records_ms":
                      times["torch_sort_same_records_ms"]})
            del keys
            torch.cuda.empty_cache()
    del vals
    small = {}
    for label, kind, below, with_values, chunks, knobs in DIST_SMALL:
        m = 1 << (log2n - below)
        keys = torch.from_numpy(dist_small_keys(np, kind, m)).to(dev)
        v = (torch.arange(m, dtype=torch.int32, device=dev) if with_values
             else None)
        small[label] = dist_case(torch, label, keys, v, P, chunks,
                                 exhausted=label == "retry_exhausts",
                                 **knobs)
        del keys, v
    need(small["retry_converges"]["exchange_attempts"] > 1,
         "dist retry_converges: converged in one attempt")
    tiny = torch.from_numpy(dist_small_keys(np, "retry", P)).to(dev)
    small["degenerate"] = dist_case(
        torch, "degenerate_chunks_gt_n_local", tiny,
        torch.arange(P, dtype=torch.int32, device=dev), P, 2)
    need(small["degenerate"]["valid_max"] == 0,
         "dist degenerate: a shard reports valid keys")
    torch.cuda.empty_cache()
    nccl = dist_nccl(torch, np, 1 << (log2n - 2), reps, dev)
    torch.cuda.empty_cache()
    bucketing = bucketing_routes(torch, np, 1 << (log2n - 8),
                                 1 << (log2n - 10))
    launches = main["uniform_kv_c1"]["launches"]
    sites = main["uniform_kv_c1"]["site_counts"]
    emit({"phase": "dist_summary", "main_path": "uniform_kv_c1",
          "launches": {k: launches[k] for k in (
              "histogram", "fused_pass", "local_sort", "merge_rows",
              "host_reads")},
          "sort_ms": {c: times[c]["ms"] for c in (1, 4)},
          "stages_ms": {c: times[c]["stages_ms"] for c in (1, 4)},
          "hybrid_sort_same_records_ms":
          times["hybrid_sort_same_records_ms"],
          "torch_sort_same_records_ms": times["torch_sort_same_records_ms"],
          "nccl_world1_ms": nccl["ms"],
          "bucketing_s": {k: v["seconds"] for k, v in bucketing.items()}})
    return dict(main=main, small=small, kernels=kernels, times=times,
                launches=launches, sites=sites)


# --------------------------------------------------------------------------
# serve phase: ServeEngine serving Qwen3-30B-A3B at full width
# --------------------------------------------------------------------------

#: the served model (``configs/qwen3_moe_30b_a3b.py`` unchanged: 48 layers,
#: d_model 2048, 32/4 heads of 128, 128 experts top-8 of width 768, vocab
#: 151 936, bfloat16) and its queue: 16 requests with prompts of 16–48
#: tokens, each new-token budget four times (admission classes 0–3), batch
#: 8, a cache of 320 rows, one dispatch group
SERVE_ARCH = "qwen3_moe_30b_a3b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_MAX_LEN = 16, 8, 320
SERVE_NEW_TOKENS = (16, 80, 144, 208)
#: the spans of a decode step the profile names: (label, module, function)
SERVE_SPANS = (("serve.attention", "layers", "attention"),
               ("serve.route", "moe", "_route"),
               ("serve.dispatch", "moe", "_dispatch_tables"),
               ("serve.experts", "moe", "_expert_ffn"))


def serve_queue(np, vocab):
    """The queue from a seed: prompts of 16–48 tokens, budgets permuted."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(2021)
    budgets = rng.permutation(np.repeat(
        SERVE_NEW_TOKENS, SERVE_REQUESTS // len(SERVE_NEW_TOKENS)))
    return [Request(i, rng.integers(0, vocab, int(rng.integers(16, 49)))
                    .astype(np.int32), int(budgets[i]))
            for i in range(SERVE_REQUESTS)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _partition_kpb(m):
    """The block size ``plan.single_pass_partition`` takes for m ids."""
    return max(8, min(1024, 1 << (m - 1).bit_length()))


def serve_kernels(torch, rec, ids, buckets, reps, label):
    """The fused pass of one partition (captured) and the prologue
    histogram against their plain versions at the path's shape; the fused
    row's library time is ``torch.sort(stable=True)`` + ``torch.bincount``
    of the same ids."""
    width = max(1, (buckets - 1).bit_length())
    fres = check_fused(torch, rec, ids.numel(), label, reps)
    fres["library_ms"] = cuda_ms(torch, lambda: (
        torch.sort(ids, stable=True), torch.bincount(ids, minlength=buckets)),
        reps)
    return check_histogram_s2(torch, ids, width, reps,
                              _partition_kpb(ids.numel()), label), fres


def _counted_call(torch, fn, *a, **kw):
    """``fn(*a, **kw)``, then (its result, a record of the histogram and
    fused-pass launches and counted host reads it made and of the
    synchronizing calls torch reported in it)."""
    import warnings
    from repro_torch.kernels import COUNTS
    before = dict(COUNTS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return out, dict({k: COUNTS[k] - before[k] for k in (
        "histogram", "fused_pass", "host_reads")}, syncs=len(syncs),
        sync_message=syncs[0][:300] if syncs else None)


def _counted_steps(torch, module, steps):
    """Wrap ``module.decode_step``: per call, ``_counted_call``'s record."""
    def wrap(_, fn):
        def step(*a, **kw):
            out, record = _counted_call(torch, fn, *a, **kw)
            steps.append(record)
            return out
        return step
    return _patched(module, [("step", "decode_step")], wrap)


def _captured_dispatch(moe, store):
    """Wrap ``moe.capacity_dispatch``: keep clones of its ids and tables."""
    def wrap(_, fn):
        def dispatch(ids, e, capacity, engine=None):
            out = fn(ids, e, capacity, engine=engine)
            store.append(dict(ids=ids.clone(), e=e, capacity=capacity,
                              tables=tuple(t.clone() for t in out)))
            return out
        return dispatch
    return _patched(moe, [("dispatch", "capacity_dispatch")], wrap)


def _span_wrappers(torch, make):
    """Wrap each function of ``SERVE_SPANS`` with ``make(label, fn)``;
    returns what ``_restore`` needs."""
    from repro_torch.models import layers, moe
    mods = {"layers": layers, "moe": moe}
    return [(mods[m], _patched(mods[m], [(label, attr)], make))
            for label, m, attr in SERVE_SPANS]


def serve_profile(torch, eng, tok, cache):
    """Where a decode step's time goes (after a warm-up): one step with a
    host clock around each span of ``SERVE_SPANS`` (no synchronize inside:
    the host's issue time), then one step under ``torch.profiler`` with the
    spans as ``record_function`` ranges: wall, device busy and idle share
    (kernels, copies and fills; the spans' own device ranges left out),
    each span's kernel time, the dispatch's own kernels, the top kernels,
    and any device-to-host copy."""
    from torch.profiler import ProfilerActivity, profile, record_function
    labels = [s[0] for s in SERVE_SPANS]
    host = dict.fromkeys(labels, 0.0)

    def timed(label, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[label] += (time.perf_counter() - t0) * 1e3
        return run

    def spanned(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    eng._decode(tok, cache)
    torch.cuda.synchronize()
    saved = _span_wrappers(torch, timed)
    try:
        t0 = time.perf_counter()
        eng._decode(tok, cache)
        host_issue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        host_wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, sv in saved:
            _restore(mod, sv)
    saved = _span_wrappers(torch, spanned)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._decode(tok, cache)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, sv in saved:
            _restore(mod, sv)
    events = _device_intervals(prof)
    ranges = {lb: [(a, b) for n, a, b in events if n == lb] for lb in labels}
    work = [(n, a, b) for n, a, b in events if n not in ranges]
    busy = _measure(_union([(a, b) for _, a, b in work])) / 1e3
    spans = {}
    for lb in labels:
        inside = [(n, a, b) for n, a, b in work
                  if any(lo <= a < hi for lo, hi in ranges[lb])]
        spans[lb] = {"calls": len(ranges[lb]), "host_ms": host[lb],
                     "device_ms": sum(b - a for _, a, b in inside) / 1e3,
                     "launches": len(inside)}
    by_name = {}
    for name, a, b in work:
        by_name.setdefault(name, [0.0, 0])
        by_name[name][0] += (b - a) / 1e3
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    disp = sum(v[0] for k, v in by_name.items()
               if "fused_pass_kernel" in k or "hist_kernel" in k
               or "split_total_kernel" in k)
    return {"host_wall_ms": host_wall, "host_issue_ms": host_issue,
            "profiled_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / host_wall,
            "device_launches": len(work), "spans": spans,
            "dispatch_kernels_device_ms": disp,
            "dtoh_copies": [n for n, _, _ in work
                            if n.startswith("Memcpy DtoH")],
            "top": [{"name": k[:80], "calls": v[1], "device_ms": v[0]}
                    for k, v in top[:12]]}


def serve_phase(torch, np, reps, dev):
    """``ServeEngine`` serving Qwen3-30B-A3B at its full published config on
    the card, weights from a seeded generator: (a) the admission pass's and
    the MoE dispatch's histogram and fused pass held to their plain
    versions at the path's shapes; (b) the census: 2 launches per
    ``schedule``, 96 per decode step and no host read in a step; (c) the
    queue served with the kernel engine, then batch 0 again with the MoE
    dispatch on ``engine="argsort"``: every captured dispatch table and
    every token equal; (d) prefill and decode-step times (CUDA events),
    decode tokens/s, the dispatch's share of a step, a profiled step, peak
    memory and the step's byte bound.  Frees the parameters at the end."""
    from repro_torch.configs import get_config
    from repro_torch.core import segmented
    from repro_torch.core.ranks import resolve_engine
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import init_cache, init_params, moe
    from repro_torch.serve import LENGTH_CLASS, Request, ServeEngine
    from repro_torch.serve import engine as serve_engine
    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(2021),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    emb = params["embed"]
    # one step reads every parameter but the embedding, of which one row a
    # token; every expert's weights, since all 128 capacity buffers run
    step_bytes = (param_bytes - emb.numel() * emb.element_size()
                  + SERVE_BATCH * cfg.d_model * emb.element_size())
    need(abs(n_params / cfg.param_count() - 1) < 0.01,
         f"serve: {n_params} parameters against the config's "
         f"{cfg.param_count()}")
    queue = serve_queue(np, cfg.vocab)
    classes = [min(r.max_new_tokens // LENGTH_CLASS, 255) for r in queue]
    need(sorted(set(classes)) == [0, 1, 2, 3], f"serve classes {classes}")
    eng = ServeEngine(cfg, params, SERVE_BATCH, SERVE_MAX_LEN, device=dev)
    need(resolve_engine(eng.dispatch_engine, eng.device) == "kernel",
         "serve: the default dispatch engine is not the kernels")

    # one untimed, uncounted decode step: library handles and first-launch
    # costs stay out of the counted run's prefill times
    with torch.inference_mode():
        eng._decode(torch.zeros((SERVE_BATCH, 1), dtype=torch.int32,
                                device=dev),
                    init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, device=dev))

    # (b) the counted run: schedule, then every batch; batch 0's dispatch
    # tables captured, each batch's prefill timed (CUDA events) and batch
    # 0's kept for the decode-step timing
    steps, cap_k, cap_a, prefills = [], [], [], []
    plain_prefill = eng._prefill

    def timed_prefill(reqs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = plain_prefill(reqs)
        ev[1].record()
        prefills.append((ev, max(len(r.prompt) for r in reqs),
                         None if prefills else out))
        return out

    eng._prefill = timed_prefill
    torch.cuda.synchronize()
    reset_counts()
    batches = eng.schedule(queue)
    sched = dict(COUNTS)
    need(sched["histogram"] == 1 and sched["fused_pass"] == 1
         and sched["host_reads"] == 0,
         f"serve: schedule census {sched}, expected 1 + 1, no read")
    want = np.argsort(np.asarray(classes), kind="stable")
    got = [r.rid for b in batches for r in b]
    need(got == want.tolist(), f"serve: admission order {got} != {want}")
    saved = _counted_steps(torch, serve_engine, steps)
    try:
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            dsaved = _captured_dispatch(moe, cap_k) if i == 0 else None
            try:
                eng.generate(b)
            finally:
                if dsaved:
                    _restore(moe, dsaved)
            if i == 0:
                steps0 = len(steps)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    finally:
        _restore(serve_engine, saved)
        del eng._prefill
    counts = dict(COUNTS)
    prefill = [dict(tokens=n, ms=ev[0].elapsed_time(ev[1]))
               for ev, n, _ in prefills]
    logits, cache = prefills[0][2]
    del prefills
    n_steps = sum(max(len(r.prompt) for r in b)
                  + max(r.max_new_tokens for r in b) for b in batches)
    per_step = cfg.n_layers * cfg.dispatch_groups
    need(len(steps) == n_steps, f"serve: {len(steps)} decode steps, "
         f"expected {n_steps}")
    bad = [s for s in steps if (s["histogram"], s["fused_pass"],
                                s["host_reads"]) != (per_step, per_step, 0)]
    need(not bad, f"serve: decode-step census {bad[:3]}, expected "
         f"{per_step} + {per_step} launches and no host read")
    need(counts["histogram"] == 1 + per_step * n_steps
         and counts["fused_pass"] == 1 + per_step * n_steps,
         f"serve: run census {counts}")
    for b in batches:
        for r in b:
            need(r.generated.shape == (r.max_new_tokens,)
                 and int(r.generated.min()) >= 0
                 and int(r.generated.max()) < cfg.vocab,
                 f"serve: request {r.rid} generated {r.generated.shape}")
    new_tokens = sum(r.max_new_tokens for r in queue)

    # (c) batch 0 again, the MoE dispatch on the argsort engine
    again = [Request(r.rid, r.prompt, r.max_new_tokens) for r in batches[0]]
    eng_a = ServeEngine(cfg, params, SERVE_BATCH, SERVE_MAX_LEN, device=dev,
                        dispatch_engine="argsort")
    dsaved = _captured_dispatch(moe, cap_a)
    torch.cuda.synchronize()
    reset_counts()
    try:
        eng_a.generate(again)
    finally:
        _restore(moe, dsaved)
    arg_counts = dict(COUNTS)
    need(arg_counts["histogram"] == 0 and arg_counts["fused_pass"] == 0,
         f"serve: the argsort engine launched kernels {arg_counts}")
    need(len(cap_k) == len(cap_a) == steps0 * per_step,
         f"serve: {len(cap_k)} / {len(cap_a)} dispatches captured, "
         f"expected {steps0 * per_step}")
    for i, (k, a) in enumerate(zip(cap_k, cap_a)):
        need(torch.equal(k["ids"], a["ids"]) and all(
            x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(k["tables"], a["tables"])),
            f"serve: dispatch {i} differs between the engines")
    for r, s in zip(batches[0], again):
        need(np.array_equal(r.generated, s.generated),
             f"serve: request {r.rid}'s tokens differ between the engines")

    # (a) the kernels against their plain versions at the path's shapes
    ids_adm = torch.tensor(classes, dtype=torch.int32, device=dev)
    rec = first_pass(torch, lambda: segmented.counting_partition(ids_adm,
                                                                  256))
    adm_hist, adm_fused = serve_kernels(torch, rec, ids_adm, 256, reps,
                                        "serve_admission")
    ids_moe, e, cap = (cap_k[0][k] for k in ("ids", "e", "capacity"))
    rec = first_pass(torch, lambda: segmented.capacity_dispatch(ids_moe, e,
                                                                 cap))
    moe_hist, moe_fused = serve_kernels(torch, rec, ids_moe, e, reps,
                                        "serve_moe_dispatch")
    del rec

    # (d) times on batch 0's prefilled cache: one decode step, its 48
    # dispatches, a profiled step
    with torch.inference_mode():
        tok = eng._next(logits).to(torch.int32)
        step_ms = cuda_ms(torch, lambda: eng._decode(tok, cache), reps)
        last = [c["ids"] for c in cap_k[-per_step:]]
        disp_ms = cuda_ms(torch, lambda: [moe._dispatch_tables(
            i[None], e, cap) for i in last], reps)
        prof = serve_profile(torch, eng, tok, cache)
    del logits, cache, tok
    peak = torch.cuda.max_memory_allocated() - base
    res = {"phase": "serve", "arch": SERVE_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": n_params, "param_bytes": param_bytes,
           "init_s": init_s, "requests": SERVE_REQUESTS,
           "batch": SERVE_BATCH, "max_len": SERVE_MAX_LEN,
           "batches": [[r.rid for r in b] for b in batches],
           "classes": classes, "decode_steps": n_steps,
           "dispatch_capacity": cap,
           "census": {"schedule": {k: sched[k] for k in (
               "histogram", "fused_pass")}, "per_decode_step": {
               "histogram": per_step, "fused_pass": per_step,
               "host_reads": 0}, "run": {k: counts[k] for k in (
                   "histogram", "fused_pass", "host_reads")}},
           "syncs_in_steps": sum(s["syncs"] for s in steps),
           "steps_with_syncs": [i for i, s in enumerate(steps)
                                if s["syncs"]][:10],
           "first_sync": next((s["sync_message"] for s in steps
                               if s["syncs"]), None),
           "engines_equal": {"dispatches": len(cap_k), "tokens": True},
           "serve_wall_ms": serve_ms, "new_tokens": new_tokens,
           "serve_tokens_per_s": new_tokens / (serve_ms / 1e3),
           "prefill": prefill, "prefill_ms": prefill[0]["ms"],
           "prefill_ms_per_token": prefill[0]["ms"] / prefill[0]["tokens"],
           "decode_step_ms": step_ms,
           "decode_tokens_per_s": SERVE_BATCH / (step_ms / 1e3),
           "dispatch_ms": disp_ms, "dispatch_share": disp_ms / step_ms,
           "step_bytes": step_bytes,
           "step_bound_ms": bound_ms(step_bytes),
           "peak_mem_bytes": peak, "profile": prof}
    emit(res)
    del eng, eng_a, params, leaves, emb, cap_k, cap_a, plain_prefill
    return dict(res, launches=counts, kernels={
        "histogram_moe_dispatch": (moe_hist, counts["histogram"] - 1),
        "fused_pass_moe_dispatch": (moe_fused, counts["fused_pass"] - 1),
        "fused_pass_admission": (adm_fused, sched["fused_pass"])},
        admission_histogram=adm_hist)


# --------------------------------------------------------------------------
# the training path: Trainer.run on Qwen3-30B-A3B at full width
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen3_moe_30b_a3b"
#: the one cut: 6 of 48 layers (AdamW's 12 bytes a parameter: 6 layers and
#: the embedding and head are 52.3 GB of state; 48 layers would be 366 GB)
TRAIN_LAYERS = 6
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_TIMED = 4096, 8, 8, 3
#: H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores,
#: float32 off them (the port's attention einsums run in float32)
BF16_FLOP_PER_S, F32_FLOP_PER_S = 989e12, 67e12


def train_flops(cfg, seq, micro):
    """(bf16, float32) matmul FLOPs of one train step from the shapes: per
    layer the projections and every expert's capacity rows (bf16), the
    router and the naive attention's full S x S scores and values
    (float32); the head (bf16).  Layers run forward, recompute and
    backward (4x the forward), the head forward and backward (3x)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads_padded, cfg.n_kv_padded
    cap = max(4, int(cfg.capacity_factor * seq * cfg.top_k
                     / cfg.num_experts))
    proj = 2 * seq * d * (h + 2 * kv) * hd + 2 * seq * h * hd * d
    experts = 3 * 2 * cfg.num_experts * cap * d * cfg.d_ff
    attn = 2 * 2 * h * seq * seq * hd
    router = 2 * seq * d * cfg.num_experts
    head = 2 * seq * d * cfg.padded_vocab
    bf16 = micro * (cfg.n_layers * 4 * (proj + experts) + 3 * head)
    f32 = micro * cfg.n_layers * 4 * (attn + router)
    return bf16, f32


def _bit_sums(torch, tree):
    """One int64 per leaf: the sum of its bit patterns (any changed value
    almost surely changes it), on the device."""
    views = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.stack([t.view(views[t.element_size()]).sum(
        dtype=torch.int64) for t in _leaves(tree)])


def _counted_train_steps(torch, step_fn, records):
    """Wrap a train step: CUDA events around it and ``_counted_call``'s
    record."""
    def step(state, batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out, record = _counted_call(torch, step_fn, state, batch)
        ev[1].record()
        records.append(dict(record, events=ev, metrics=out[1],
                            issue_ms=(time.perf_counter() - t0) * 1e3))
        return out
    return step


def train_engines(torch, cfg, params, batch):
    """One microbatch (one sequence) through ``loss_fn`` and its backward
    (remat on) with the MoE dispatch on the kernels, then on argsort:
    every dispatch table (the forward's and the recompute's), the loss and
    every gradient's bits equal.  Returns the launch counts of both."""
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import loss_fn, moe
    leaves = list(_leaves(params))
    mb = {k: v[:1] for k, v in batch.items()}
    runs = {}
    for engine in ("kernel", "argsort"):
        cap = []
        torch.cuda.synchronize()
        reset_counts()
        saved = _captured_dispatch(moe, cap)
        try:
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = loss_fn(params, cfg, mb, remat=True, engine=engine)
            loss.backward()
        finally:
            _restore(moe, saved)
            for p in leaves:
                p.requires_grad_(False)
        sums = _bit_sums(torch, [p.grad for p in leaves])
        for p in leaves:
            p.grad = None
        runs[engine] = dict(cap=cap, loss=loss.detach(), sums=sums,
                            counts=dict(COUNTS))
    k, a = runs["kernel"], runs["argsort"]
    need(len(k["cap"]) == len(a["cap"]) == 2 * cfg.n_layers,
         f"train: {len(k['cap'])} / {len(a['cap'])} dispatches captured, "
         f"expected {2 * cfg.n_layers} (forward + recompute)")
    for i, (x, y) in enumerate(zip(k["cap"], a["cap"])):
        need(torch.equal(x["ids"], y["ids"]) and all(
            s.dtype == t.dtype and torch.equal(s, t)
            for s, t in zip(x["tables"], y["tables"])),
            f"train: dispatch {i} differs between the engines")
    n = cfg.n_layers
    for i in range(n):       # the recompute runs the layers in reverse
        fwd, again = k["cap"][i], k["cap"][2 * n - 1 - i]
        need(torch.equal(fwd["ids"], again["ids"]) and all(
            torch.equal(s, t) for s, t in zip(fwd["tables"],
                                               again["tables"])),
            f"train: layer {i}'s recomputed dispatch differs")
    need(torch.equal(k["loss"], a["loss"]),
         f"train: loss {float(k['loss'])} (kernel) != {float(a['loss'])}")
    need(torch.equal(k["sums"], a["sums"]),
         "train: the engines' gradients differ")
    need(a["counts"]["histogram"] == 0 and a["counts"]["fused_pass"] == 0,
         f"train: the argsort engine launched kernels {a['counts']}")
    per = cfg.n_layers * cfg.dispatch_groups * 2
    need(k["counts"]["histogram"] == per and k["counts"]["fused_pass"] == per,
         f"train: one microbatch's census {k['counts']}, expected {per}")
    return {"dispatches": len(k["cap"]), "loss": float(k["loss"]),
            "grad_leaves": len(leaves), "tables_equal": True,
            "loss_equal": True, "grads_bitwise_equal": True,
            "kernel_counts": {x: k["counts"][x] for x in (
                "histogram", "fused_pass", "host_reads")}}


def train_profile(torch, tr, state):
    """One more step under ``torch.profiler``, each ``capacity_dispatch``
    a ``record_function`` range: device busy and idle share of the step,
    the dispatches' device time (their kernels and glue) and share, the
    histogram and fused-pass kernels' own time, the top kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe

    def spanned(_, fn):
        def run(*a, **kw):
            with record_function("train.dispatch"):
                return fn(*a, **kw)
        return run

    saved = _patched(moe, [("dispatch", "capacity_dispatch")], spanned)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = tr.run(state, 1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        _restore(moe, saved)
    events = _device_intervals(prof)
    spans = _union([(a, b) for n, a, b in events if n == "train.dispatch"])
    work = [(n, a, b) for n, a, b in events if n != "train.dispatch"]
    busy = _measure(_union([(a, b) for _, a, b in work])) / 1e3
    inside = _measure(_intersect(_union([(a, b) for _, a, b in work]),
                                 spans)) / 1e3
    by_name = {}
    for name, a, b in work:
        by_name.setdefault(name, [0.0, 0])
        by_name[name][0] += (b - a) / 1e3
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    kern = sum(v[0] for k, v in by_name.items()
               if "fused_pass_kernel" in k or "hist_kernel" in k
               or "split_total_kernel" in k)
    return state, {"wall_ms": wall, "device_busy_ms": busy,
                   "device_idle_share": 1 - busy / wall,
                   "device_launches": len(work),
                   "dispatch_spans": len([1 for n, _, _ in events
                                          if n == "train.dispatch"]),
                   "dispatch_device_ms": inside,
                   "dispatch_share": inside / busy,
                   "dispatch_kernels_device_ms": kern,
                   "top": [{"name": k[:80], "calls": v[1], "device_ms": v[0]}
                           for k, v in top[:12]]}


def train_resume(torch, dev):
    """The smoke Qwen3 on the card through ``Trainer``: 7 steps with a
    checkpoint at 5, a new trainer resumed there and run 5 more, against
    an uninterrupted 10-step run, float32 and bit for bit."""
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import Trainer
    cfg = get_smoke_config(TRAIN_ARCH)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4)

    def trainer(d, every):
        return Trainer(cfg, data, d, ckpt_every=every, log_every=100,
                       total_steps=50, microbatches=2)

    with tempfile.TemporaryDirectory() as root:
        a = os.path.join(root, "a")
        gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
        tr = trainer(a, 5)
        state = tr.run(tr.init_or_resume(gen()), 7)
        need(int(state.step) == 7, "train resume: the first run's step")
        tr2 = trainer(a, 5)
        state2 = tr2.init_or_resume(gen())
        need(int(state2.step) == 5, f"train resume: resumed at "
             f"{int(state2.step)}, expected 5")
        state2 = tr2.run(state2, 5)
        tr3 = trainer(os.path.join(root, "b"), 100)
        state3 = tr3.run(tr3.init_or_resume(gen()), 10)
    x, y = list(_leaves(state2)), list(_leaves(state3))
    need(len(x) == len(y), "train resume: the states differ in structure")
    bitwise = all(s.dtype == t.dtype and torch.equal(s, t)
                  for s, t in zip(x, y))
    err = max(float((s.double() - t.double()).abs().max())
              for s, t in zip(x, y))
    need(bitwise, f"train resume: the resumed run is not bit-equal to the "
         f"uninterrupted one (off by {err})")
    return {"steps": 10, "resumed_at": 5, "leaves": len(x),
            "bitwise": bitwise, "max_abs_diff": err}


def train_phase(torch, np, reps, dev):
    """``Trainer.run`` on Qwen3-30B-A3B at its full published width, cut to
    ``TRAIN_LAYERS`` layers (bf16, AdamW, remat on), on ``SyntheticLMData``
    at 8 x 4096 tokens in 8 microbatches: (a) one sequence's forward and
    backward on both dispatch engines (``train_engines``); (b) a warm-up
    step (lr 0: no parameter may change) and ``TRAIN_TIMED`` timed steps,
    counted: 96 histograms and 96 fused passes a step, no host read, loss
    and gradient norm finite, parameters changed; (c) one profiled step;
    (d) the histogram and the fused pass at the step's dispatch shape
    (32 768 ids into 128 experts) against their plain versions; (e) peak
    memory; (f) the smoke resume (``train_resume``).  Frees the state at
    the end."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import segmented
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import moe
    from repro_torch.train import Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    ckpt = tempfile.TemporaryDirectory()
    tr = Trainer(cfg, data, ckpt.name, ckpt_every=1 << 30, log_every=1,
                 microbatches=TRAIN_MICRO)
    t0 = time.perf_counter()
    state = tr.init_or_resume(torch.Generator(device=dev).manual_seed(2022))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(state.params))
    need(abs(n_params / cfg.param_count() - 1) < 0.01,
         f"train: {n_params} parameters against the config's "
         f"{cfg.param_count()}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(state[:2]))

    # (a) the engines on one sequence
    engines = train_engines(torch, cfg, state.params, data.batch(0))

    # (b) the counted run: a warm-up step with the dispatches captured,
    # then the timed steps
    records, cap, sums = [], [], []
    tr._step_fn = _counted_train_steps(torch, tr._step_fn, records)
    sums.append(_bit_sums(torch, state.params))
    torch.cuda.synchronize()
    reset_counts()
    saved = _captured_dispatch(moe, cap)
    try:
        state = tr.run(state, 1)
    finally:
        _restore(moe, saved)
    sums.append(_bit_sums(torch, state.params))
    state = tr.run(state, TRAIN_TIMED, on_step=lambda s, st, m: sums.append(
        _bit_sums(torch, st.params)))
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    per = 2 * cfg.n_layers * cfg.dispatch_groups * TRAIN_MICRO
    bad = [(r["histogram"], r["fused_pass"], r["host_reads"])
           for r in records if (r["histogram"], r["fused_pass"],
                                r["host_reads"]) != (per, per, 0)]
    need(not bad, f"train: step census {bad}, expected {per} + {per} "
         f"launches and no host read")
    steps = []
    for i, r in enumerate(records):
        m = {k: float(v) for k, v in r["metrics"].items()}
        need(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
             and m["grad_norm"] > 0, f"train: step {i} metrics {m}")
        changed = int((sums[i + 1] != sums[i]).sum())
        steps.append(dict(step=i, ms=r["events"][0].elapsed_time(
            r["events"][1]), issue_ms=r["issue_ms"], changed_leaves=changed,
            syncs=r["syncs"], **m))
    need(steps[0]["lr"] == 0.0 and steps[0]["changed_leaves"] == 0,
         f"train: step 0 (lr 0) changed {steps[0]['changed_leaves']} leaves")
    need(steps[2]["changed_leaves"] > 0, "train: step 2 changed no parameter")
    timed = [s["ms"] for s in steps[1:]]
    step_ms = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bf16, f32 = train_flops(cfg, TRAIN_SEQ, TRAIN_MICRO)
    bound = (bf16 / BF16_FLOP_PER_S + f32 / F32_FLOP_PER_S) * 1e3

    # (c) a profiled step
    state, prof = train_profile(torch, tr, state)

    # (d) the kernels at the step's dispatch shape
    ids, e, capacity = (cap[0][k] for k in ("ids", "e", "capacity"))
    need(ids.numel() == TRAIN_SEQ * cfg.top_k and e == cfg.num_experts,
         f"train: dispatch of {ids.numel()} ids into {e}")
    rec = first_pass(torch, lambda: segmented.capacity_dispatch(ids, e,
                                                                 capacity))
    hist, fused_res = serve_kernels(torch, rec, ids, e, reps,
                                    "train_moe_dispatch")
    del rec, cap
    peak = torch.cuda.max_memory_allocated() - base
    del state, tr
    ckpt.cleanup()
    torch.cuda.empty_cache()

    # (f) the smoke resume
    resume = train_resume(torch, dev)
    res = {"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "optimizer": cfg.optimizer, "remat": cfg.remat,
           "params": n_params, "state_bytes": state_bytes, "init_s": init_s,
           "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "microbatches": TRAIN_MICRO, "dispatch_capacity": capacity,
           "census": {"per_step": {"histogram": per, "fused_pass": per,
                                   "host_reads": 0},
                      "run": {k: counts[k] for k in (
                          "histogram", "fused_pass", "host_reads")}},
           "steps": steps, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "step_flops_bf16": bf16, "step_flops_f32": f32,
           "step_bound_ms": bound, "step_bound_by": "operations",
           "achieved_tflop_per_s": (bf16 + f32) / step_ms / 1e9,
           "syncs_in_steps": sum(s["syncs"] for s in steps),
           "first_sync": next((r["sync_message"] for r in records
                               if r["syncs"]), None),
           "profile": prof, "dispatch_share": prof["dispatch_share"],
           "peak_mem_bytes": peak, "engines": engines, "resume": resume}
    emit(res)
    return dict(res, launches=counts, kernels={
        "histogram_train_dispatch": (hist, counts["histogram"]),
        "fused_pass_train_dispatch": (fused_res, counts["fused_pass"])})


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


# --------------------------------------------------------------------------
# the launch phase: a one-rank NCCL mesh, compressed_psum, the dry run
# --------------------------------------------------------------------------

LAUNCH_ARCH = "qwen3_moe_30b_a3b"
#: the one cut: 2 of 48 layers.  The state (bf16 weights, float32 AdamW
#: moments: 22.4 GB at 2 layers) is held twice at once while the
#: unsharded step works on copies
LAUNCH_LAYERS = 2
LAUNCH_SEQ, LAUNCH_BATCH, LAUNCH_MICRO = 4096, 2, 2
#: the dry run's cells: Qwen3-30B-A3B's three shapes on both meshes
DRYRUN_MESHES = ("pod", "multipod")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 600


def start_dryrun(tmp):
    """``python -m repro_torch.launch.dryrun`` for ``LAUNCH_ARCH``, one
    process a mesh, run at once (each fake 256- / 512-rank group must not
    meet this process's NCCL group), with no card visible: they run on
    meta tensors, on the host.  Returns the processes and the start."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for mesh in DRYRUN_MESHES:
        out = os.path.join(tmp, mesh)
        os.makedirs(out)
        with open(os.path.join(out, "dryrun.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 LAUNCH_ARCH, "--mesh", mesh, "--out", out], cwd=HERE,
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, time.perf_counter()


def stop(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryrun(procs, t0, tmp):
    """Wait for the dry runs; print each cell's row on its own line; fail
    unless every cell of ``DRYRUN_SHAPES`` x ``DRYRUN_MESHES`` is ``ok``."""
    cells, tails = [], []
    for mesh, proc in zip(DRYRUN_MESHES, procs):
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            stop(procs)
            raise Failure(f"launch: the dry run ran past {DRYRUN_TIMEOUT_S} s")
        with open(os.path.join(tmp, mesh, "dryrun.log")) as f:
            tail = f.read()[-3000:]
        need(proc.returncode == 0, f"launch: the {mesh} dry run exited "
             f"{proc.returncode}: {tail}")
        with open(os.path.join(tmp, mesh, "summary.json")) as f:
            cells += json.load(f)
        tails.append(tail)
    seconds = time.perf_counter() - t0
    bad = [f"{c['mesh']}/{c['shape']}: {c.get('error')}" for c in cells
           if not c.get("ok") and not c.get("skipped")]
    need(not bad, "launch: dry-run cells failed: " + " | ".join(bad)
         + "\n" + "\n".join(tails))
    rows = {}
    for c in cells:
        if c.get("skipped"):
            continue
        rows[(c["mesh"], c["shape"])] = c
        emit({"phase": "dryrun", "reckoned_with": "H100 SXM constants "
              "(utils/roofline.py), not measured", **{k: c[k] for k in (
                  "arch", "mesh", "shape", "step", "chips",
                  "mem_per_chip_gib", "t_compute_s", "t_memory_s",
                  "t_collective_s", "bottleneck", "mfu_bound", "fits_80gb",
                  "counted_flops_per_chip", "model_flops", "run_s")},
              "memory": c["memory"], "collective_counts":
              c["collective_counts"]})
    want = {(m, sh) for m in DRYRUN_MESHES for sh in DRYRUN_SHAPES}
    need(want <= set(rows), f"launch: dry-run cells missing: "
         f"{sorted(want - set(rows))}")
    return {"cells": len(rows), "seconds": seconds}


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def launch_phase(torch, np, reps, dev, keep=None):
    """(a) One train step of Qwen3-30B-A3B at its full published width, cut
    to ``LAUNCH_LAYERS`` layers, on a one-rank NCCL ``DeviceMesh`` (1, 1):
    parameters, optimizer state and batch DTensors placed by the sharding
    rules, the dispatch tables built under ``local_map``; held against the
    unsharded ``make_train_step`` on the same inputs (loss, gradient norm
    and every updated parameter bit for bit; the same histogram and
    fused-pass launches); each step timed again (CUDA events).  (b)
    ``compressed_psum`` over that group bit-equal to the int8 round trip.
    (c) The dry run of Qwen3-30B-A3B's three shapes on the pod and
    multipod meshes, started first, one process a mesh (its artifacts, one
    directory per mesh, copied into ``keep`` when it is given).  (d) The
    histogram and the fused pass at the mesh step's dispatch shape against
    their plain versions."""
    import dataclasses
    import tempfile
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import segmented
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.models import init_params, moe
    from repro_torch.optim import (compressed_psum, get_optimizer,
                                   int8_compress, int8_decompress)
    from repro_torch.train import TrainState, make_train_step
    tmp = tempfile.TemporaryDirectory()
    dry = start_dryrun(tmp.name)
    try:
        cfg = dataclasses.replace(get_config(LAUNCH_ARCH),
                                  n_layers=LAUNCH_LAYERS)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        data = SyntheticLMData(vocab=cfg.vocab, seq_len=LAUNCH_SEQ,
                               global_batch=LAUNCH_BATCH, seed=0,
                               device=str(dev))
        batch = data.batch(1)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(23),
                             device=dev)
        opt = get_optimizer(cfg.optimizer)
        # step 1: the schedule's lr is above 0, so every leaf may change
        state = TrainState(params, opt.init(params),
                           torch.ones((), dtype=torch.int32, device=dev))
        n_params = sum(t.numel() for t in _leaves(params))

        def timed(fn, *a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            out, rec = _counted_call(torch, fn, *a)
            ev[1].record()
            ev[1].synchronize()
            return out, dict(rec, ms=ev[0].elapsed_time(ev[1]),
                             wall_ms=(time.perf_counter() - t0) * 1e3)

        # (a) the unsharded step on copies, twice (the second timed)
        _, plain = make_train_step(cfg, microbatches=LAUNCH_MICRO,
                                   donate=False)
        (new, m_plain), rec_plain = timed(plain, state, batch)
        want = [t for t in _leaves(new.params)]
        del new
        _, rec_plain2 = timed(plain, state, batch)
        torch.cuda.empty_cache()

        # the one-rank NCCL group and its (1, 1) mesh
        M.open_group(device_type="cuda")
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            dstate = TrainState(
                shd.distribute(state.params, shd.param_shardings(
                    state.params, cfg, mesh), mesh),
                shd.distribute(state.opt_state, shd.param_shardings(
                    state.opt_state, cfg, mesh), mesh), state.step)
            dbatch = shd.distribute(batch, shd.to_shardings(shd.batch_specs(
                cfg, mesh, SHAPES["train_4k"]), mesh), mesh)
            del state, params
            _, on_mesh = make_train_step(cfg, microbatches=LAUNCH_MICRO)
            cap = []
            saved = _captured_dispatch(moe, cap)
            try:
                with M.use_mesh(mesh):
                    (dnew, m_mesh), rec_mesh = timed(on_mesh, dstate, dbatch)
            finally:
                _restore(moe, saved)
            got = [_full(t) for t in _leaves(dnew.params)]
            need(len(got) == len(want), "launch: the trees differ")
            same = [a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want)]
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(got, want))
            loss = (float(_full(m_mesh["loss"])), float(m_plain["loss"]))
            gnorm = (float(_full(m_mesh["grad_norm"])),
                     float(m_plain["grad_norm"]))
            need(torch.equal(_full(m_mesh["loss"]), m_plain["loss"]),
                 f"launch: loss {loss[0]} on the mesh, {loss[1]} off it")
            need(torch.equal(_full(m_mesh["grad_norm"]),
                             m_plain["grad_norm"]),
                 f"launch: gradient norm {gnorm[0]} on the mesh, "
                 f"{gnorm[1]} off it")
            need(all(same), f"launch: {same.count(False)} of {len(same)} "
                 f"parameters differ (max {diff})")
            census = {k: (rec_mesh[k], rec_plain[k]) for k in (
                "histogram", "fused_pass", "host_reads")}
            per = 2 * cfg.n_layers * cfg.dispatch_groups * LAUNCH_MICRO
            need(rec_mesh["histogram"] == rec_plain["histogram"] == per
                 and rec_mesh["fused_pass"] == rec_plain["fused_pass"] == per,
                 f"launch: census (mesh, plain) {census}, expected {per}")
            del got, want
            # a second mesh step, timed (from the updated state)
            with M.use_mesh(mesh):
                _, rec_mesh2 = timed(on_mesh, dnew, dbatch)
            del dnew, dstate
            backend = torch.distributed.get_backend()
            peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.empty_cache()

            # (b) compressed_psum over the group
            gen = torch.Generator(device=dev).manual_seed(5)
            x = torch.randn((1 << 24) + 7, device=dev, generator=gen)
            want_x = int8_decompress(*int8_compress(x), x.shape)
            got_x = compressed_psum(x, (mesh, "data"))
            need(torch.equal(got_x, want_x),
                 "launch: compressed_psum differs from the int8 round trip")
            psum_ms = cuda_ms(torch, lambda: compressed_psum(
                x, (mesh, "data")), reps)
            del x, want_x, got_x
        finally:
            M.close_group()

        # (d) the kernels at the mesh step's dispatch shape
        ids, e, capacity = (cap[0][k] for k in ("ids", "e", "capacity"))
        need(len(cap) == per and ids.numel() == LAUNCH_SEQ * cfg.top_k,
             f"launch: {len(cap)} dispatches of {ids.numel()} ids")
        rec = first_pass(torch, lambda: segmented.capacity_dispatch(
            ids, e, capacity))
        hist, fused_res = serve_kernels(torch, rec, ids, e, reps,
                                        "launch_mesh_dispatch")
        del rec, cap
        torch.cuda.empty_cache()

        # (c) the dry run
        dryrun = finish_dryrun(*dry, tmp.name)
        if keep is not None:
            import shutil
            shutil.copytree(tmp.name, keep, dirs_exist_ok=True)
    finally:
        stop(dry[0])
        tmp.cleanup()
    res = {"phase": "launch", "arch": LAUNCH_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params,
           "seq_len": LAUNCH_SEQ, "global_batch": LAUNCH_BATCH,
           "microbatches": LAUNCH_MICRO, "mesh": [1, 1], "backend": backend,
           "loss": loss[0], "grad_norm": gnorm[0], "loss_equal": True,
           "grad_norm_equal": True, "params_bitwise_equal": True,
           "leaves": len(same), "census": {"per_step": per, "mesh_plain":
                                            census},
           "plain_step_ms": [rec_plain["ms"], rec_plain2["ms"]],
           "mesh_step_ms": [rec_mesh["ms"], rec_mesh2["ms"]],
           "plain_step_wall_ms": [rec_plain["wall_ms"],
                                  rec_plain2["wall_ms"]],
           "mesh_step_wall_ms": [rec_mesh["wall_ms"], rec_mesh2["wall_ms"]],
           "mesh_over_plain": rec_mesh2["ms"] / rec_plain2["ms"],
           "syncs": {"plain": rec_plain2["syncs"],
                     "mesh": rec_mesh2["syncs"]},
           "peak_mem_bytes": peak, "compressed_psum": {
               "elements": (1 << 24) + 7, "bitwise_equal": True,
               "ms": psum_ms}, "dryrun": dryrun}
    emit(res)
    launches = {"histogram": rec_mesh["histogram"],
                "fused_pass": rec_mesh["fused_pass"]}
    src = "src/repro_torch/kernels/csrc/"
    return [dict(name=name, route="cuda", source=src + cu, replaces=rep,
                 launches=launches[key], **_k(r), bound_by="bytes",
                 library_ms=r["library_ms"])
            for name, key, cu, rep, r in (
                ("histogram_mesh_dispatch", "histogram", "histogram.cu",
                 "src/repro/kernels/histogram.py:28", hist),
                ("fused_pass_mesh_dispatch", "fused_pass", "fused_pass.cu",
                 "src/repro/kernels/fused.py:129", fused_res))]

# --------------------------------------------------------------------------
# the contract layer (repro_torch.analysis) on the card
# --------------------------------------------------------------------------

#: the main path's launch counters under the recorder's kernel names
ANALYSIS_KERNELS = {"histogram": "_hist_kernel",
                    "fused_pass": "_fused_pass_kernel",
                    "local_sort": "_bitonic_stable_kernel",
                    "merge_rows": "merge_rows"}


def analysis_phase(torch, np, log2n, dev):
    """Every registered contract with the CUDA kernels (``run_all``, each
    under the recorder, the sort counter, the write replays and
    ``torch.profiler``) and the lint; then the main path at full size, the
    2^log2n uint32 KV ``hybrid_sort`` at Table 3's (4,0) config, counted,
    under the recorder, the sort counter and the profiler: census ``2 +
    classes`` with ``1 + passes + classes`` launches, the recorder's counts
    equal to the profiler's kernel by kernel (and to the launch counters),
    no sort op, the alternates written in place, the key and value sweep
    bytes exactly ``(2p + 1)·n_pad·4 + 2p·n_pad·4``, and the result equal
    to ``torch.sort(stable=True)``."""
    from repro_torch import hybrid_sort
    from repro_torch.analysis import contracts, lint, transfer
    from repro_torch.analysis.trace import recording
    from repro_torch.core import hybrid, model
    from repro_torch.kernels import COUNTS, fused, reset_counts
    from repro_torch.utils.census import (SortCounter, launch_census,
                                          profiler_kernel_counts)
    t0 = time.perf_counter()
    reports = contracts.run_all(dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    bad = [f for r in reports for f in r.findings]
    lint_findings = [str(f) for f in lint.run_lint(
        os.path.join(HERE, "src", "repro_torch"))]
    emit({"phase": "analysis_contracts", "device": "cuda",
          "seconds": sweep_s, "contracts": {r.name: r.ok for r in reports},
          "findings": bad, "lint": lint_findings})
    need(not bad, f"analysis: {len(bad)} finding(s): {bad[:5]}")
    need(not lint_findings, f"analysis: lint findings {lint_findings}")

    n = 1 << log2n
    rng = np.random.default_rng(24)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    cfg = model.default_config(4)
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    with recording() as rec, SortCounter() as sorts:
        (out_k, out_v, st), profiled, names = profiler_kernel_counts(
            lambda: hybrid_sort(keys, vals, cfg=cfg, return_stats=True))
    main_s = time.perf_counter() - t1
    counts = dict(COUNTS)
    p = st.counting_passes
    params = dict(contracts.hybrid_params(n, cfg, vals=1, val_bytes=4),
                  passes=p, executed=p, elided=st.elided_passes)
    decl = hybrid.ANALYSIS_CONTRACT
    rep = contracts.check_run("main_path", decl, rec, sorts, params,
                              device="cuda", profiled=profiled,
                              device_names=names)
    recorded = rec.counts()
    for key, name in ANALYSIS_KERNELS.items():
        need(counts[key] > 0, f"analysis: {key} was not launched: {counts}")
        need(counts[key] == recorded.get(name, 0),
             f"analysis: {key} launched {counts[key]} times, recorded "
             f"{recorded.get(name, 0)}")
    cen = launch_census(rec)
    classes = len(hybrid.local_sort_classes(n, cfg))
    n_pad = fused.pad_length(n, cfg.kpb)
    want_bytes = (2 * p + 1) * n_pad * 4 + 2 * p * n_pad * 4
    got_bytes = transfer.derive_hbm_bytes(rec.records, decl["transfer"],
                                          params)["total"]
    need(rep.ok, f"analysis: main path: {rep.findings}")
    need(cen["total"] == 2 + classes and
         cen["launches"] == 1 + p + classes,
         f"analysis: census {cen}, classes {classes}, passes {p}")
    need(sorts.sorts == 0, f"analysis: sort ops at {sorts.sites}")
    need(got_bytes == want_bytes,
         f"analysis: sweep bytes {got_bytes} != {want_bytes}")
    ref_k, ref_i = reference_sort(torch, keys)
    need(same_bits(torch, out_k, ref_k) and
         torch.equal(out_v.to(torch.int64), ref_i),
         "analysis: the recorded sort differs from torch.sort(stable=True)")
    del ref_k, ref_i, out_k, out_v, keys, vals
    torch.cuda.empty_cache()
    res = {"phase": "analysis", "contracts": {r.name: r.ok for r in reports},
           "sweep_s": sweep_s, "lint": "green",
           "main_path": {"n": n, "values": "int32", "d": cfg.d,
                         "kpb": cfg.kpb, "passes": p,
                         "elided": st.elided_passes, "classes": classes,
                         "census": cen, "launches": counts,
                         "recorded": recorded, "profiler": profiled,
                         "sort_ops": sorts.sorts, "sweep_bytes": got_bytes,
                         "formula_bytes": want_bytes, "seconds": main_s}}
    emit(res)
    return res


def analysis_process(log2n):
    """The analysis phase in a process of its own, started after the other
    phases: late in this long process ``torch.profiler`` dropped kernel
    events of short windows (the histogram of a chunk sort, a whole slab
    sweep) that the launch counters, the recorder and the write replays
    all saw, while a fresh process traces every one.  Its JSON lines are
    passed on; returns the phase's result, failing if the process
    failed."""
    code = ("import sys, torch, numpy as np\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "import chip_smoke\n"
            "try:\n"
            "    chip_smoke.analysis_phase(torch, np, "
            f"{int(log2n)}, torch.device('cuda', 0))\n"
            "except chip_smoke.Failure as exc:\n"
            "    sys.exit(f'chip_smoke: FAILED: {exc}')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                          capture_output=True, text=True, timeout=900)
    res = None
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if line.startswith("{"):
            obj = json.loads(line)
            if obj.get("phase") == "analysis":
                res = obj
    need(proc.returncode == 0 and res is not None,
         f"the analysis process failed (rc {proc.returncode}): "
         f"{proc.stderr.strip()[-2000:]}")
    return res


def run_analysis_only(torch, np, log2n, reps, dev):
    """``--only analysis``: the phase, then the main path's four kernels
    held to their plain versions at its shapes (phase 3's checks) for the
    kernels line, with the launches of the phase's counted run."""
    res = analysis_phase(torch, np, log2n, dev)
    return main_path_rows(torch, np, log2n, reps, dev,
                          res["main_path"]["launches"])


def main_path_rows(torch, np, log2n, reps, dev, launches):
    """The kernels line's rows 1-3 and 10 for a phase run alone: the main
    path's histogram, fused pass, local sort and ``merge_rows`` held to
    their plain versions at its shapes (phase 3's checks), beside
    ``launches``, the counts of that phase's counted runs."""
    n = 1 << log2n
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    hist = check_histogram(torch, keys, 6912, reps)["uniform"]
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    rec_kv = capture(torch, keys, vals, passes=1)
    fused_res = check_fused(torch, rec_kv["passes"][0], n, "kv_pass0", reps)
    merge_res = check_merge_rows(torch, rec_kv["merge"][0], reps)
    local_res = check_local_sort(torch, rec_kv, reps, "kv")
    del rec_kv, keys, vals
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/"
    return [
        dict(name="histogram", route="cuda", source=src + "histogram.cu",
             replaces="src/repro/kernels/histogram.py:28",
             launches=launches["histogram"], **_k(hist), bound_by="bytes",
             library_ms=hist["library_ms"]),
        dict(name="fused_pass", route="cuda", source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=launches["fused_pass"], **_k(fused_res),
             bound_by="bytes", library_ms=None),
        dict(name="local_sort", route="cuda", source=src + "local_sort.cu",
             replaces="src/repro/kernels/bitonic.py:94",
             launches=launches["local_sort"], **_k(local_res),
             bound_by="bytes", library_ms=local_res["library_ms"]),
        dict(name="merge_rows", route="cuda", source=src + "merge_rows.cu",
             replaces="src/repro/core/plan.py:250",
             launches=launches["merge_rows"], **_k(merge_res),
             bound_by="bytes", library_ms=None)]


# --------------------------------------------------------------------------
# the examples phase: the user-facing entry points on the card
# --------------------------------------------------------------------------

#: the kernels each in-process entry must launch (rows 1-3 and 10 of the
#: kernel table; merge_rows only where a sort merges small buckets)
SORT_KERNELS = ("histogram", "fused_pass", "local_sort")
PARTITION_KERNELS = ("histogram", "fused_pass")
#: train_moe's two runs: to step 100, then the same command to step 200
TRAIN_MOE_STEPS = (100, 200)
#: the printed checks every entry's lines must hold true
FLAG_RE = (r"(?:\bok=|perm ok=|sorted=|pairs move together: |f32: )"
           r"(True|False)")
PROBE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def load_entry(rel):
    """The entry point at ``rel`` (a script, not a package module) as a
    module, its ``main`` not run."""
    import importlib.util
    name = "entry_" + os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_entry(torch, label, fn, kernels):
    """``fn()`` with the launch counters at 0 and under the launch
    recorder, its printed lines captured (and passed on): fails unless it
    ran, launched each of ``kernels`` at least once, launched no plain
    version, and the counters agree with the recorder.  Returns (its
    result, its text, its record)."""
    import contextlib
    import io
    import traceback
    from repro_torch.analysis.trace import recording
    from repro_torch.kernels import COUNTS, reset_counts
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with recording() as rec, contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
    except Exception as exc:
        sys.stdout.write(buf.getvalue())
        raise Failure(f"examples: {label} failed: {type(exc).__name__}: "
                      f"{exc}\n{traceback.format_exc()[-2000:]}")
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    launches = {k: COUNTS[k] for k in ANALYSIS_KERNELS}
    recorded = rec.counts()
    plain = sum(r.plain for r in rec.records)
    need(plain == 0, f"examples: {label} ran {plain} plain versions")
    for key, name in ANALYSIS_KERNELS.items():
        need(launches[key] == recorded.get(name, 0),
             f"examples: {label}: {key} counted {launches[key]}, recorded "
             f"{recorded.get(name, 0)}")
    need(all(launches[k] > 0 for k in kernels),
         f"examples: {label} did not launch all of {kernels}: {launches}")
    return out, text, {"seconds": seconds, "launches": launches,
                       "plain_launches": plain}


def flags_true(label, text, at_least):
    """Every printed ``ok=`` / ``perm ok=`` / ``sorted=`` / ``pairs move
    together`` / ``f32:`` value is True, and there are ``at_least``."""
    import re
    vals = re.findall(FLAG_RE, text)
    need(len(vals) >= at_least and all(v == "True" for v in vals),
         f"examples: {label} printed {vals}, expected {at_least}+ True")
    return len(vals)


def merged_artifacts(src_dirs, out):
    """The dry run's per-mesh artifact directories as one: every cell's
    file, and one ``summary.json`` of all their cells."""
    import glob
    import shutil
    os.makedirs(out)
    summary = []
    for d in src_dirs:
        for path in glob.glob(os.path.join(d, "*.json")):
            if path.endswith("summary.json"):
                with open(path) as f:
                    summary += json.load(f)
            else:
                shutil.copy(path, out)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f)
    return summary


def check_tables(text, cells):
    """Each ``ok`` cell appears once in its mesh's dry-run table, and each
    ``ok`` pod cell once in the baseline roofline table."""
    sections, title = {}, None
    for line in text.splitlines():
        if line.startswith("### "):
            title = line[4:]
            sections[title] = []
        elif title is not None and line.startswith("| "):
            sections[title].append(line)
    found = {}
    for c in cells:
        if not c.get("ok"):
            continue
        row = f"| {c['arch']} | {c['shape']} | "
        want = [t for t in sections if t.startswith(
            f"Dry-run — {c['mesh']} mesh")]
        if c["mesh"] == "pod":
            want += [t for t in sections if t.startswith(
                "Roofline — baseline")]
        need(want, f"examples: no table for {c['mesh']}: {list(sections)}")
        for t in want:
            hits = sum(line.startswith(row) for line in sections[t])
            need(hits == 1, f"examples: {c['mesh']}/{c['shape']} appears "
                 f"{hits} times in '{t}'")
            found[t] = found.get(t, 0) + 1
    return found


def script_process(rel, args=(), cwd=HERE):
    """A scripts/ entry in a process of its own (host work: the probe's
    fake 512-rank group must not meet this process's groups)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen([sys.executable, os.path.join(HERE, rel),
                             *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_process(label, proc, timeout):
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise Failure(f"examples: {label} ran past {timeout} s")
    sys.stdout.write(out)
    need(proc.returncode == 0, f"examples: {label} exited {proc.returncode}: "
         f"{err.strip()[-2000:]}")
    return out, time.perf_counter() - t0


def _first_ids(module, attr, store):
    """Wrap ``module.<attr>`` (a partition or dispatch whose ids come
    first): keep a clone of its first call's ids and the positional
    arguments after them."""
    def wrap(_, fn):
        def call(ids, *a, **kw):
            if not store:
                store.append((ids.clone(), a))
            return fn(ids, *a, **kw)
        return call
    return _patched(module, [(attr, attr)], wrap)


def examples_phase(torch, np, dev, reps, dryrun_dir=None):
    """The seven user-facing entry points, each as a user runs it, at the
    reference's sizes: ``torch_smoke_sort``, ``torch_quickstart``,
    ``torch_distributed_sort`` (``LocalMesh(8)``), ``torch_serve_decode``
    and ``torch_train_moe`` (the 100M config, to step 100, then the same
    command to step 200, resumed from its step-100 checkpoint in a
    temporary directory) in this process, each counted and recorded: the
    CUDA kernels launched, no plain version; every printed ``ok`` true;
    ``torch_probe_multipod`` (host work, its own process): ``PROBE OK``
    and each of the five collective kinds; ``torch_make_experiments_
    tables`` on the dry run's artifacts (``dryrun_dir``: the launch
    phase's, one directory per mesh; None: the dry run is started here,
    beside the entries): every ``ok`` Qwen3 cell once per table.  Then the
    histogram and the fused pass are held to their plain versions at the
    shapes these entries gave them: ``serve_decode``'s admission partition
    and the first MoE dispatch of ``train_moe``'s step 1."""
    import re
    import tempfile
    from repro_torch.core import segmented
    from repro_torch.models import moe
    from repro_torch.serve import engine as serve_engine
    tmp = tempfile.TemporaryDirectory()
    t_phase = time.perf_counter()
    procs = []
    try:
        if dryrun_dir is None:
            dry = start_dryrun(tmp.name)
            procs += dry[0]
            dryrun_dir = tmp.name
        probe = script_process("scripts/torch_probe_multipod.py")
        procs.append(probe)
        entries, total = {}, {k: 0 for k in ANALYSIS_KERNELS}

        def add(label, rec, **numbers):
            entries[label] = dict(rec, **numbers)
            for k in total:
                total[k] += rec["launches"][k]

        smoke = load_entry("scripts/torch_smoke_sort.py")
        stats, text, rec = run_entry(torch, "smoke_sort",
                                     lambda: smoke.run(), SORT_KERNELS)
        need("SMOKE OK" in text and "LSD ok" in text,
             "examples: smoke_sort did not print SMOKE OK")
        add("smoke_sort", rec, ok_lines=flags_true("smoke_sort", text, 7),
            counting_passes={k: s.counting_passes for k, s in stats.items()
                             if s is not None},
            local_sort={k: s.used_local_sort for k, s in stats.items()
                        if s is not None})

        quick = load_entry("examples/torch_quickstart.py")
        stats, text, rec = run_entry(torch, "quickstart",
                                     lambda: quick.run(), SORT_KERNELS)
        need("lsd(d=5) agrees with hybrid" in text,
             "examples: quickstart's LSD line is missing")
        add("quickstart", rec, ok_lines=flags_true("quickstart", text, 3),
            counting_passes={k: s.counting_passes for k, s in stats.items()},
            local_sort={k: s.used_local_sort for k, s in stats.items()})

        dsort = load_entry("examples/torch_distributed_sort.py")
        res, text, rec = run_entry(torch, "distributed_sort",
                                   lambda: dsort.run(), SORT_KERNELS)
        cases = {}
        for name, (out, _, st) in res.items():
            valid = st.valid.cpu().numpy()
            cases[name] = {
                "attempts": int(st.exchange_attempts[0]),
                "overflow": bool(st.overflow.any()),
                "shard_fill": float(valid.mean() * len(valid) / out.shape[0])}
            need(not cases[name]["overflow"],
                 f"examples: distributed_sort {name} overflowed")
        del res
        add("distributed_sort", rec,
            ok_lines=flags_true("distributed_sort", text, 5), cases=cases)
        torch.cuda.empty_cache()

        serve = load_entry("examples/torch_serve_decode.py")
        adm = []
        saved = _first_ids(serve_engine, "counting_partition", adm)
        try:
            served, text, rec = run_entry(torch, "serve_decode",
                                          lambda: serve.run(),
                                          PARTITION_KERNELS)
        finally:
            _restore(serve_engine, saved)
        gen = [r for b in served for r in b]
        need(len(gen) == 10 and all(
            len(r.generated) == r.max_new_tokens for r in gen),
             "examples: serve_decode served the wrong requests or lengths")
        add("serve_decode", rec, batches=len(served),
            generated_tokens=sum(len(r.generated) for r in gen))

        train = load_entry("examples/torch_train_moe.py")
        ckpt = os.path.join(tmp.name, "train_moe_torch")
        parts, disp = [], []
        for steps in TRAIN_MOE_STEPS:
            saved = _first_ids(moe, "capacity_dispatch", disp)
            try:
                got, text, rec = run_entry(
                    torch, f"train_moe_{steps}",
                    lambda s=steps: train.run(steps=s, ckpt=ckpt),
                    PARTITION_KERNELS)
            finally:
                _restore(moe, saved)
            ran = steps - got["start"]
            need(ran > 0 and len(got["losses"]) == ran and all(
                np.isfinite(v) for v in got["losses"].values()),
                 f"examples: train_moe to {steps}: losses {got['losses']}")
            parts.append((steps, got, text, rec))
        need("[trainer] resumed from step" not in parts[0][2] and
             f"[trainer] resumed from step {TRAIN_MOE_STEPS[0]}"
             in parts[1][2] and parts[1][1]["start"] == TRAIN_MOE_STEPS[0],
             "examples: train_moe did not resume from its checkpoint")
        for steps, got, text, rec in parts:
            ran = steps - got["start"]
            # the trainer's own average at its last log line: the steps
            # without the final wait for the last checkpoint's writer
            logged = re.findall(r"\[trainer\] step \d+ .* (\d+) ms/step",
                                text)
            add(f"train_moe_{steps}", rec, params=got["params"],
                start=got["start"], steps=ran,
                loss=got["losses"][steps],
                ms_per_step=got["seconds"] / ran * 1e3,
                logged_ms_per_step=int(logged[-1]) if logged else None)
        del parts
        torch.cuda.empty_cache()

        # the two kernels against their plain versions at these entries'
        # shapes (uncounted runs)
        need(len(adm) == 1 and len(disp) == 1,
             f"examples: captured {len(adm)} admission partitions and "
             f"{len(disp)} dispatches")
        ids, (buckets,) = adm[0][0], adm[0][1][:1]
        kernels = {}
        rec = first_pass(torch, lambda: segmented.counting_partition(
            ids, buckets))
        hist, fres = serve_kernels(torch, rec, ids, buckets, reps,
                                   "examples_admission")
        launches = entries["serve_decode"]["launches"]
        kernels["histogram_examples_admission"] = (
            hist, launches["histogram"])
        kernels["fused_pass_examples_admission"] = (
            fres, launches["fused_pass"])
        ids, (e, capacity) = disp[0][0], disp[0][1][:2]
        rec = first_pass(torch, lambda: segmented.capacity_dispatch(
            ids, e, capacity))
        hist, fres = serve_kernels(torch, rec, ids, e, reps,
                                   "examples_train_moe_dispatch")
        runs = [entries[f"train_moe_{s}"]["launches"]
                for s in TRAIN_MOE_STEPS]
        kernels["histogram_examples_dispatch"] = (
            hist, sum(r["histogram"] for r in runs))
        kernels["fused_pass_examples_dispatch"] = (
            fres, sum(r["fused_pass"] for r in runs))
        shapes = {"admission": [int(adm[0][0].numel()), int(buckets)],
                  "dispatch": [int(ids.numel()), int(e), int(capacity)]}
        del rec, ids, adm, disp

        # the probe (started first, on the host)
        text, probe_s = finish_process("probe_multipod", probe, 600)
        need("PROBE OK" in text, "examples: the probe did not print PROBE OK")
        counts = {}
        for line in text.splitlines():
            kind = line.split(" ")[0]
            if kind in PROBE_KINDS:
                counts[kind] = int(line.split(" ")[1])
        need(all(counts.get(k, 0) >= 1 for k in PROBE_KINDS),
             f"examples: the probe counted {counts}")
        entries["probe_multipod"] = {"collectives": counts}

        # the tables, from the dry run's cells of both meshes
        if dryrun_dir == tmp.name:
            finish_dryrun(*dry, tmp.name)
        cells = merged_artifacts(
            [os.path.join(dryrun_dir, m) for m in DRYRUN_MESHES],
            os.path.join(tmp.name, "tables", "dryrun"))
        tproc = script_process("scripts/torch_make_experiments_tables.py",
                               ("dryrun",), cwd=os.path.join(tmp.name,
                                                             "tables"))
        procs.append(tproc)
        _, tables_s = finish_process("make_experiments_tables", tproc, 300)
        with open(os.path.join(tmp.name, "tables", "artifacts",
                               "tables_torch.md")) as f:
            found = check_tables(f.read(), cells)
        need(sum(1 for c in cells if c.get("ok")) == len(
            [(m, s) for m in DRYRUN_MESHES for s in DRYRUN_SHAPES]),
             f"examples: {len(cells)} dry-run cells")
        entries["make_experiments_tables"] = {"seconds": tables_s,
                                              "rows": found}
    finally:
        stop(procs)
        tmp.cleanup()
    res = {"phase": "examples", "seconds": time.perf_counter() - t_phase,
           "entries": entries, "launches": total, "kernel_shapes": shapes}
    emit(res)
    return dict(res, kernels=kernels)


def examples_rows(res):
    """The examples phase's rows of the kernels line: the histogram and
    the fused pass at the admission and MoE-dispatch shapes its entries
    gave them."""
    src = "src/repro_torch/kernels/csrc/"
    return [dict(name=name, route="cuda",
                 source=src + ("histogram.cu" if name.startswith("histogram")
                               else "fused_pass.cu"),
                 replaces=("src/repro/kernels/histogram.py:28"
                           if name.startswith("histogram")
                           else "src/repro/kernels/fused.py:129"),
                 launches=launches, **_k(r), bound_by="bytes",
                 library_ms=r["library_ms"])
            for name, (r, launches) in res["kernels"].items()]


def run_examples_only(torch, np, log2n, reps, dev):
    """``--only examples``: the phase (with its own dry run), then rows
    1-3 and 10 of the kernels line held to their plain versions."""
    res = examples_phase(torch, np, dev, reps)
    return (main_path_rows(torch, np, log2n, reps, dev, res["launches"])
            + examples_rows(res))


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

    if args.only == "train":
        return finish(torch, run_train(torch, np, args.reps, dev))
    if args.only == "launch":
        return finish(torch, run_launch(torch, np, args.reps, dev))
    if args.only == "analysis":
        return finish(torch, run_analysis_only(torch, np, args.log2n,
                                               args.reps, dev))
    if args.only == "examples":
        return finish(torch, run_examples_only(torch, np, args.log2n,
                                               args.reps, dev))

    # the serve phase: Qwen3-30B-A3B at full width through ServeEngine (its
    # own counted runs; the 61 GB of parameters freed before the next phase)
    serve = serve_phase(torch, np, args.reps, dev)
    need(all(serve["launches"][k] > 0 for k in ("histogram", "fused_pass")),
         f"a kernel of the serve path was not launched: {serve['launches']}")
    torch.cuda.empty_cache()
    need(torch.cuda.memory_allocated() < (1 << 30),
         f"serve: {torch.cuda.memory_allocated()} bytes still allocated")
    src = "src/repro_torch/kernels/csrc/"
    serve_rows = [
        dict(name=name, route="cuda",
             source=src + ("histogram.cu" if name.startswith("histogram")
                           else "fused_pass.cu"),
             replaces=("src/repro/kernels/histogram.py:28"
                       if name.startswith("histogram")
                       else "src/repro/kernels/fused.py:129"),
             launches=launches, **_k(res), bound_by="bytes",
             library_ms=res["library_ms"])
        for name, (res, launches) in serve["kernels"].items()]
    if args.only == "serve":
        return finish(torch, serve_rows)
    # the train phase: Trainer.run on Qwen3-30B-A3B at full width, 6
    # layers (its own counted runs; the ~60 GB of state freed after it)
    train_rows = run_train(torch, np, args.reps, dev)

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

    # slice S4: the distributed sort over 8 shards on the card, length
    # bucketing's three routes (their own counted runs)
    dres = dist_phase(torch, np, args.log2n, args.reps, dev)
    need(all(dres["launches"][k] > 0 for k in (
        "histogram", "fused_pass", "local_sort", "merge_rows")),
         f"a kernel of the dist path was not launched: {dres['launches']}")
    torch.cuda.empty_cache()

    # phase 5: the out-of-core path (its own counted runs)
    kmerge_res, ooc_launches = ooc_phases(torch, np, args.log2n, args.reps)
    need(all(ooc_launches[k] > 0 for k in ("histogram", "fused_pass",
                                           "local_sort", "merge")),
         f"a kernel of the ooc path was not launched: {ooc_launches}")

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
    kernels += [
        dict(name=f"fused_pass_dist_{site}", route="cuda",
             source=src + "fused_pass.cu",
             replaces="src/repro/kernels/fused.py:129",
             launches=dres["sites"][site]["fused_pass"],
             **_k(dres["kernels"][site]), bound_by="bytes", library_ms=None)
        for site in ("exchange", "compaction")]
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
    # the contract layer: every contract with the CUDA kernels, then the
    # main path at full size under the recorder and the profiler (its own
    # counted run, in a process of its own)
    torch.cuda.empty_cache()
    analysis = analysis_process(args.log2n)

    # the launch phase: the one-rank NCCL mesh step, compressed_psum and
    # the dry run (its own counted runs), whose artifacts the examples
    # phase's tables script reads
    import tempfile
    with tempfile.TemporaryDirectory() as dry_dir:
        launch_rows = run_launch(torch, np, args.reps, dev, keep=dry_dir)
        kernels += serve_rows + train_rows + launch_rows
        # the examples phase: the seven user-facing entry points (their
        # own counted runs)
        examples = examples_phase(torch, np, dev, args.reps,
                                  dryrun_dir=dry_dir)
        kernels += examples_rows(examples)
    emit({"phase": "summary", "main_path": "uint32_uniform_kv",
          "host_reads": launches["host_reads"], "sort_ms": main["ms"],
          "torch_sort_ms": main["torch_sort_ms"], "d9_sort_ms": d9["ms"],
          "d12_kv_sort_ms": wide[12]["sort"]["ms"],
          "d16_sort_ms": wide[16]["sort"]["ms"],
          "lsd_kv_d8_ms": s2["lsd"]["uint32_kv_d8"]["by_kpb"],
          "lsd_d5_ms": s2["lsd"]["uint32_d5"]["by_kpb"],
          "dist_kv_ms": {c: dres["times"][c]["ms"] for c in (1, 4)},
          "serve_decode_step_ms": serve["decode_step_ms"],
          "serve_decode_tokens_per_s": serve["decode_tokens_per_s"],
          "serve_step_bound_ms": serve["step_bound_ms"],
          "analysis_sweep_s": analysis["sweep_s"],
          "analysis_main_path_s": analysis["main_path"]["seconds"],
          "train_step_ms": TRAIN_SUMMARY.get("step_ms"),
          "train_tokens_per_s": TRAIN_SUMMARY.get("tokens_per_s"),
          "examples_s": examples["seconds"]})
    return finish(torch, kernels)


#: the train phase's step time and rate, for the summary line
TRAIN_SUMMARY = {}


def run_train(torch, np, reps, dev):
    """The train phase, its launches checked, the state freed; returns its
    rows of the kernels line."""
    train = train_phase(torch, np, reps, dev)
    need(all(train["launches"][k] > 0 for k in ("histogram", "fused_pass")),
         f"a kernel of the train path was not launched: {train['launches']}")
    torch.cuda.empty_cache()
    need(torch.cuda.memory_allocated() < (1 << 30),
         f"train: {torch.cuda.memory_allocated()} bytes still allocated")
    TRAIN_SUMMARY.update(step_ms=train["step_ms"],
                         tokens_per_s=train["tokens_per_s"])
    src = "src/repro_torch/kernels/csrc/"
    return [dict(name=name, route="cuda",
                 source=src + ("histogram.cu" if name.startswith("histogram")
                               else "fused_pass.cu"),
                 replaces=("src/repro/kernels/histogram.py:28"
                           if name.startswith("histogram")
                           else "src/repro/kernels/fused.py:129"),
                 launches=launches, **_k(res), bound_by="bytes",
                 library_ms=res["library_ms"])
            for name, (res, launches) in train["kernels"].items()]


def run_launch(torch, np, reps, dev, keep=None):
    """The launch phase, its launches checked, the card emptied after it;
    returns its rows of the kernels line (``keep``: see
    :func:`launch_phase`)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rows = launch_phase(torch, np, reps, dev, keep=keep)
    need(all(r["launches"] > 0 for r in rows),
         f"a kernel of the mesh path was not launched: {rows}")
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_allocated() - before
    need(kept < (1 << 30), f"launch: {kept} bytes still allocated")
    return rows


def finish(torch, kernels) -> int:
    """The last three lines: the kernels, the card's name and power limit,
    and the result."""
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
    parser.add_argument("--only", choices=("serve", "train", "launch",
                                           "analysis", "examples"),
                        help="run only this phase (a quick check)")
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
