#!/usr/bin/env python3
"""Times a checkout's own package on one NVIDIA GPU, for comparing two
checkouts (a parent and a change) in one call to the card.

Run from the root of the checkout whose package is timed (its ``src/``
comes first on the path), naming this script by its path:

    cd <checkout> && python3 <repo>/scripts/torch_checkout_times.py \
        [merge] [zipf] [kv] [multisplit] [int64] [float32]
        [histogram] [wide] [merge_rows] [assigned] [lsd]
        [assigned_pair=<other checkout>]

``merge`` times ``kway_merge_round`` on ``chip_smoke.py``'s out-of-core
round (4 sorted runs of 2^28 uniform uint32 keys, an int32 index leaf,
kway 4) at tiles 4096 and 256 and checks the output is sorted; ``zipf``
times ``hybrid_sort`` on ``chip_smoke.py``'s Zipf(1.5) 2^26 uint32 keys
and ``kv`` on 2^28 uniform uint32 keys with an int32 index (the main
path's KV case, Table 3's (4,0) config), outside that script's run, and
each of its executed fused passes on the arguments a first run recorded; ``multisplit`` times
``tile_multisplit`` and ``tile_multisplit_kv`` on tiles of the shape of
``chip_smoke.py``'s library phase ((38 837, 6912) uniform uint32 keys,
int32 values, shift 24, width 8); ``int64`` times ``hybrid_sort`` on 2^25
uniform int64 keys and ``float32`` on 2^26 normal float32 keys with
zeros, infinities and NaNs and an int32 index (``chip_smoke.py``'s int64
and float32 cases), and each profiles one more run with
``torch.profiler``: the device's busy time (the sum of its kernels,
copies and memsets) beside the run's wall time, and the largest device
entries; ``histogram`` times ``digit_total`` on 2^28 uniform uint32
keys at width 8 (the main path's prologue, shift 24) and on 2^24 at width
16 (null where the checkout refuses it); ``wide`` times ``hybrid_sort``
on ``chip_smoke.py``'s wide-digit cases (2^26 uniform uint32 keys with an
int32 index at d = 12, 2^24 keys alone at d = 16, Table 3's (4,0) config
otherwise) and each of their executed fused passes (the fused pass's wide
variant) on the arguments a first run recorded; ``merge_rows`` times
``plan.merge_rows`` on the first (a_max, r) histogram of the 2^28 KV sort
at d = 8 (r = 256) and of those two sorts (r = 4096, 65536); ``assigned``
times ``assigned_histogram`` at ``chip_smoke.py``'s library shape
((38 837, 6912) uniform uint32 tiles, 43 692 slots of which 4 855 padding,
valid 0) at widths 1, 4, 8 (shift 24) and 9, and on (512, 6912) uint32
tiles at widths 9, 12 and 16 (41 timed runs each, the others 9), with
each result checked against the plain version; ``lsd`` times ``lsd_sort`` on 2^28 uniform uint32 keys
at d = 5 and with an int32 index at d = 8 (kpb 1024 and 6912), on 2^25
int64 keys at d = 8, and ``counting_partition`` of 2^28 uniform ids into
384 and 65 536 buckets (the latter also at kpb 6912; null where the
checkout has no S2), each with a profiled run (device busy time and the
largest device entries); ``assigned_pair=<other checkout>`` launches this
checkout's assigned histogram and the other's (built from its source) in
one process, alternating, at the library shape (width 8) and on the
(512, 6912) tiles at widths 9, 12 and 16.  Medians of the timed runs after a warm-up, CUDA
events; one JSON line each.
"""
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def event_ms(fn, reps):
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times[1:]


def merge_times(dev):
    from repro_torch.core import bijection
    from repro_torch.kernels import merge
    from repro_torch.kernels.fused import pad_length
    m = 1 << 28
    gen = torch.Generator(device=dev).manual_seed(1611)
    runs = []
    for _ in range(4):
        x = torch.randint(-2**31, 2**31, (m,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        runs.append(bijection.sortable(torch.sort(bijection.sortable(x))
                                       .values))
    n = 4 * m
    keys = torch.cat(runs + [runs[0].new_full((pad_length(n, 4096) - n,),
                                              -1)])
    del runs
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    ak, av = torch.empty_like(keys), torch.empty_like(vals)
    out = {}
    for tile in (4096, 256):
        tables = merge.merge_path_partition(keys, [m] * 4, 4, tile)
        out[f"tile{tile}_ms"] = statistics.median(event_ms(
            lambda: merge.kway_merge_round(keys, (vals,), ak, (av,), *tables,
                                           kway=4, tpb=tile, n=n), 3))
        s = bijection.sortable(ak[:n])
        out[f"tile{tile}_sorted"] = bool((s[1:] >= s[:-1]).all())
        del tables, s
    return out


def zipf_times(dev):
    from repro_torch import hybrid_sort
    rng = np.random.default_rng(2016)
    rng.integers(0, 2**32, 1 << 28, dtype=np.uint32)   # chip_smoke's order
    zipf = np.minimum(rng.zipf(1.5, 1 << 26), 2**32 - 1).astype(np.uint32)
    keys = torch.from_numpy(zipf).to(dev)
    times = event_ms(lambda: hybrid_sort(keys), 5)
    return {"zipf_ms": times, "zipf_median_ms": statistics.median(times)}


def kv_times(dev):
    from repro_torch import hybrid_sort
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.integers(0, 2**32, 1 << 28,
                                         dtype=np.uint32)).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    out = pass_times(recorded(keys, vals, None), "kv", 9)
    torch.cuda.empty_cache()
    times = event_ms(lambda: hybrid_sort(keys, vals), 5)
    return {**out, "kv_ms": times, "kv_median_ms": statistics.median(times)}


def multisplit_times(dev):
    from repro_torch import kernels as K
    tiles = -(-(1 << 28) // 6912)
    keys = torch.from_numpy(np.random.default_rng(1614).integers(
        0, 2**32, (tiles, 6912), dtype=np.uint32)).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    keys_ms = event_ms(lambda: K.tile_multisplit(keys, 24, 8, 32), 5)
    kv_ms = event_ms(lambda: K.tile_multisplit_kv(keys, vals, 24, 8, 32, 32),
                     5)
    return {"shape": [tiles, 6912], "keys_ms": keys_ms,
            "keys_median_ms": statistics.median(keys_ms), "kv_ms": kv_ms,
            "kv_median_ms": statistics.median(kv_ms)}


def profiled_sort(name, keys, vals=None):
    """Times ``hybrid_sort`` and profiles one more run: the device's busy
    time beside the run's wall time, and the largest device entries."""
    from repro_torch import hybrid_sort
    return profiled(name, lambda: hybrid_sort(keys, vals))


def profiled(name, fn, reps=7):
    """Times ``fn`` and profiles one more run, as ``profiled_sort``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    times = event_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
    # a record_function span's device-side copy is no device work
    spans = {ev.name for ev in prof.events()
             if getattr(ev, "is_user_annotation", False)}
    rows = sorted(((getattr(ev, "self_device_time_total", 0) / 1e3, ev.count,
                    ev.key[:60]) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.key not in spans), reverse=True)
    return {f"{name}_ms": times, f"{name}_median_ms": statistics.median(times),
            "profiled_wall_ms": s.elapsed_time(e),
            "device_busy_ms": sum(r[0] for r in rows),
            "top": [[key, calls, ms] for ms, calls, key in rows[:8]]}


def int64_times(dev):
    keys = torch.from_numpy(np.random.default_rng(2025).integers(
        -2**63, 2**63 - 1, 1 << 25, dtype=np.int64)).to(dev)
    return profiled_sort("int64", keys)


def float32_times(dev):
    rng = np.random.default_rng(2026)
    f = (rng.standard_normal(1 << 26) * 1e3).astype(np.float32)
    f[rng.choice(f.size, 4096, replace=False)] = np.resize(np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan], np.float32), 4096)
    keys = torch.from_numpy(f).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    return profiled_sort("float32", keys, vals)


def histogram_times(dev):
    from repro_torch.kernels import histogram
    out = {}
    for log2n, width in ((28, 8), (24, 16)):
        keys = torch.from_numpy(np.random.default_rng(log2n).integers(
            0, 2**32, 1 << log2n, dtype=np.uint32)).to(dev).view(torch.int32)
        try:
            times = event_ms(lambda: histogram.digit_total(
                keys, keys.numel(), 32 - width, width), 9)
        except ValueError:
            times = None
        out[f"n{log2n}_w{width}_ms"] = times
        out[f"n{log2n}_w{width}_median_ms"] = (statistics.median(times)
                                                if times else None)
    return out


#: Table 3's (4,0) config, as chip_smoke.py's wide cases take it
WIDE_CFG = dict(kpb=6912, local_threshold=9216, merge_threshold=3000)


def recorded(keys, vals, cfg):
    """Runs ``hybrid_sort`` once, recording clones of the arguments of every
    fused pass and of the first ``merge_rows`` call."""
    from repro_torch import hybrid_sort
    from repro_torch.core import plan
    from repro_torch.kernels import fused
    rec = {"passes": [], "merge": None}
    orig_pass, orig_merge = fused.fused_counting_pass, plan.merge_rows

    def pass_hook(src_keys, src_vals, alt_keys, alt_vals, sc, *tables, **kw):
        rec["passes"].append((src_keys.clone(),
                              tuple(v.clone() for v in src_vals), tuple(sc),
                              tuple(t.clone() for t in tables), dict(kw)))
        return orig_pass(src_keys, src_vals, alt_keys, alt_vals, sc, *tables,
                         **kw)

    def merge_hook(hist, lt, mt):
        if rec["merge"] is None:
            rec["merge"] = (hist.clone(), lt, mt)
        return orig_merge(hist, lt, mt)

    fused.fused_counting_pass, plan.merge_rows = pass_hook, merge_hook
    try:
        hybrid_sort(keys, vals, cfg=cfg)
    finally:
        fused.fused_counting_pass, plan.merge_rows = orig_pass, orig_merge
    torch.cuda.synchronize()
    return rec


def pass_times(rec, label, reps):
    """Each recorded fused pass timed on its own arguments."""
    from repro_torch.kernels import fused
    out = {}
    for i, (k, v, sc, tables, kw) in enumerate(rec["passes"]):
        ak, av = torch.empty_like(k), tuple(torch.empty_like(x) for x in v)
        times = event_ms(lambda: fused.fused_counting_pass(
            k, v, ak, av, sc, *tables, **kw), reps)
        out[f"{label}_pass{i}_ms"] = times
        out[f"{label}_pass{i}_median_ms"] = statistics.median(times)
    return out


def wide_inputs(dev, d):
    """chip_smoke.py's wide-digit case at d: (keys, values or None, cfg)."""
    from repro_torch.core.model import SortConfig
    n, with_values = {12: (1 << 26, True), 16: (1 << 24, False)}[d]
    keys = torch.from_numpy(np.random.default_rng(2017 + d).integers(
        0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = (torch.arange(n, dtype=torch.int32, device=dev) if with_values
            else None)
    return keys, vals, SortConfig(d=d, **WIDE_CFG)


def wide_times(dev):
    from repro_torch import hybrid_sort
    out = {}
    for d in (12, 16):
        keys, vals, cfg = wide_inputs(dev, d)
        out.update(pass_times(recorded(keys, vals, cfg), f"d{d}", 5))
        torch.cuda.empty_cache()
        times = event_ms(lambda: hybrid_sort(keys, vals, cfg=cfg), 5)
        out[f"d{d}_sort_ms"] = times
        out[f"d{d}_sort_median_ms"] = statistics.median(times)
        del keys, vals
        torch.cuda.empty_cache()
    return out


def merge_rows_times(dev):
    from repro_torch.core import plan
    from repro_torch.core.model import SortConfig
    keys = torch.from_numpy(np.random.default_rng(11).integers(
        0, 2**32, 1 << 28, dtype=np.uint32)).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    cases = [(keys, vals, SortConfig(d=8, **WIDE_CFG))]
    cases += [wide_inputs(dev, d) for d in (12, 16)]
    out = {}
    for keys, vals, cfg in cases:
        hist, lt, mt = recorded(keys, vals, cfg)["merge"]
        times = event_ms(lambda: plan.merge_rows(hist, lt, mt), 9)
        r = hist.shape[1]
        out[f"r{r}_rows"] = hist.shape[0]
        out[f"r{r}_ms"] = times
        out[f"r{r}_median_ms"] = statistics.median(times)
    return out


def assigned_times(dev):
    from repro_torch.kernels import assigned, ref
    rng = np.random.default_rng(1614)
    tiles = -(-(1 << 28) // 6912)
    pad = -(-tiles // 8)
    keys = torch.from_numpy(rng.integers(0, 2**32, (tiles, 6912),
                                         dtype=np.uint32)).to(dev)
    idx = torch.from_numpy(np.concatenate([
        rng.permutation(tiles), np.zeros(pad, np.int64)]).astype(
            np.int32)).to(dev)
    valid = torch.cat([torch.ones(tiles, dtype=torch.int32, device=dev),
                       torch.zeros(pad, dtype=torch.int32, device=dev)])
    small = keys[:512]
    sidx = torch.arange(512, dtype=torch.int32, device=dev)
    sval = torch.ones_like(sidx)
    out = {"slots": idx.numel()}
    cases = [("lib", keys, idx, valid, 24, w) for w in (1, 4, 8)]
    cases += [("lib", keys, idx, valid, 23, 9)]
    cases += [("tiles512", small, sidx, sval, 32 - w - 1, w)
              for w in (9, 12, 16)]
    for label, k, i, v, shift, width in cases:
        got = assigned.assigned_histogram(k, i, v, shift, width)
        equal = bool(torch.equal(got, ref.assigned_histogram_ref(
            k, i, v, shift, width)))
        times = event_ms(lambda: assigned.assigned_histogram(
            k, i, v, shift, width), 9 if label == "lib" else 41)
        out[f"{label}_w{width}_equal"] = equal
        out[f"{label}_w{width}_median_ms"] = statistics.median(times)
    return out


def assigned_pair_times(dev, other):
    """This checkout's assigned histogram and ``other``'s (its
    ``csrc/histogram.cu`` built here with this checkout's flags; the two
    launchers must share one C signature), launched in one process in 12
    rounds of 41 timed runs each, which one goes first alternating."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build, assigned, ref
    src = os.path.join(os.path.abspath(other), "src", "repro_torch",
                       "kernels", "csrc")
    so = _build.build_dir().parent / "other" / "histogram.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-o",
                    str(so), os.path.join(src, "histogram.cu")], check=True,
                   capture_output=True)
    fns = {"this": _build.function("histogram", "assigned_histogram_launch",
                                   assigned._ARGS),
           "other": ctypes.CDLL(str(so)).assigned_histogram_launch}
    fns["other"].argtypes, fns["other"].restype = assigned._ARGS, ctypes.c_int
    rng = np.random.default_rng(1614)
    tiles = -(-(1 << 28) // 6912)
    keys = torch.from_numpy(rng.integers(0, 2**32, (tiles, 6912),
                                         dtype=np.uint32)).to(dev)
    idx = torch.from_numpy(rng.permutation(tiles).astype(np.int32)).to(dev)
    cases = [("lib", keys, idx, 24, 8)]
    cases += [("tiles512", keys[:512], torch.arange(
        512, dtype=torch.int32, device=dev), 32 - w - 1, w)
        for w in (9, 12, 16)]
    out = {"other": other, "rounds": 12}
    for label, k, i, shift, width in cases:
        v = torch.ones_like(i)
        b = k.view(torch.int32)
        res = torch.empty((i.numel(), 1 << width), dtype=torch.int32,
                          device=dev)
        want = ref.assigned_histogram_ref(k, i, v, shift, width)

        def launch(fn):
            rc = fn(b.data_ptr(), 4, b.shape[0], b.shape[1], i.data_ptr(),
                    v.data_ptr(), i.numel(), shift, width, 1,
                    res.data_ptr(), ctypes.c_void_p(
                        torch.cuda.current_stream().cuda_stream))
            assert rc == 0, rc

        times = {"this": [], "other": []}
        for who, fn in fns.items():
            res.zero_()
            launch(fn)
            out[f"{label}_w{width}_{who}_equal"] = bool(torch.equal(res,
                                                                    want))
        for rnd in range(12):
            for who in (("this", "other") if rnd % 2 == 0
                        else ("other", "this")):
                times[who].append(statistics.median(event_ms(
                    lambda: launch(fns[who]), 41)))
        key = f"{label}_w{width}"
        out[f"{key}_this_ms"] = times["this"]
        out[f"{key}_other_ms"] = times["other"]
        out[f"{key}_this_median_ms"] = statistics.median(times["this"])
        out[f"{key}_other_median_ms"] = statistics.median(times["other"])
        out[f"{key}_this_faster_rounds"] = sum(
            a < c for a, c in zip(times["this"], times["other"]))
    return out


def lsd_times(dev):
    try:
        from repro_torch import lsd_sort
        from repro_torch.core import plan, segmented
    except ImportError:
        return {"lsd_sort": None}
    n = 1 << 28
    keys = torch.from_numpy(np.random.default_rng(1905).integers(
        0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    i64 = torch.from_numpy(np.random.default_rng(1908).integers(
        -2**63, 2**63 - 1, 1 << 25, dtype=np.int64)).to(dev)
    ids = torch.from_numpy(np.random.default_rng(1906).integers(
        0, 384, n).astype(np.int32)).to(dev)
    wide_ids = torch.from_numpy(np.random.default_rng(1907).integers(
        0, 65536, n).astype(np.int32)).to(dev)
    cases = {"d5_kpb1024": lambda: lsd_sort(keys, d=5, kpb=1024),
             "kv_d8_kpb1024": lambda: lsd_sort(keys, vals, d=8, kpb=1024),
             "kv_d8_kpb6912": lambda: lsd_sort(keys, vals, d=8, kpb=6912),
             "int64_d8_kpb1024": lambda: lsd_sort(i64, d=8, kpb=1024),
             "partition_384": lambda: segmented.counting_partition(ids, 384),
             "partition_65536": lambda: segmented.counting_partition(
                 wide_ids, 65536),
             "partition_65536_kpb6912": lambda: plan.single_pass_partition(
                 wide_ids, 65536, kpb=6912)}
    out = {}
    for label, fn in cases.items():
        res = profiled(label, fn, 5)
        out.update({f"{label}_{k}" if k in ("profiled_wall_ms",
                                            "device_busy_ms", "top") else k:
                    v for k, v in res.items()})
    return out


def main(argv=None) -> int:
    what = (argv if argv is not None else sys.argv[1:]) or ["merge", "zipf"]
    if not torch.cuda.is_available():
        print("torch_checkout_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in what:
        name, _, arg = name.partition("=")
        fn = {"merge": merge_times, "zipf": zipf_times, "kv": kv_times,
               "multisplit": multisplit_times, "int64": int64_times,
               "float32": float32_times,
               "histogram": histogram_times, "wide": wide_times,
               "merge_rows": merge_rows_times, "assigned": assigned_times,
               "lsd": lsd_times, "assigned_pair": assigned_pair_times}[name]
        res = fn(dev, arg) if arg else fn(dev)
        print(json.dumps({"phase": f"checkout_{name}",
                          "checkout": os.path.basename(os.getcwd()), **res}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
