#!/usr/bin/env python3
"""Times a checkout's own package on one NVIDIA GPU, for comparing two
checkouts (a parent and a change) in one call to the card.

Run from the root of the checkout whose package is timed (its ``src/``
comes first on the path), naming this script by its path:

    cd <checkout> && python3 <repo>/scripts/torch_checkout_times.py \
        [merge] [zipf] [kv] [multisplit] [int64] [float32]
        [histogram] [wide] [merge_rows]

``merge`` times ``kway_merge_round`` on ``chip_smoke.py``'s out-of-core
round (4 sorted runs of 2^28 uniform uint32 keys, an int32 index leaf,
kway 4) at tiles 4096 and 256 and checks the output is sorted; ``zipf``
times ``hybrid_sort`` on ``chip_smoke.py``'s Zipf(1.5) 2^26 uint32 keys
and ``kv`` on 2^28 uniform uint32 keys with an int32 index (the main
path's KV case), outside that script's run; ``multisplit`` times
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
at d = 8 (r = 256) and of those two sorts (r = 4096, 65536).  Medians of
the timed runs after a warm-up, CUDA events; one JSON line each.
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
    times = event_ms(lambda: hybrid_sort(keys, vals), 5)
    return {"kv_ms": times, "kv_median_ms": statistics.median(times)}


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import hybrid_sort
    times = event_ms(lambda: hybrid_sort(keys, vals), 7)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        hybrid_sort(keys, vals)
        e.record()
        e.synchronize()
    rows = sorted(((getattr(ev, "self_device_time_total", 0) / 1e3, ev.count,
                    ev.key[:60]) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
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
    from repro_torch.kernels import fused
    out = {}
    for d in (12, 16):
        keys, vals, cfg = wide_inputs(dev, d)
        rec = recorded(keys, vals, cfg)
        for i, (k, v, sc, tables, kw) in enumerate(rec["passes"]):
            ak, av = torch.empty_like(k), tuple(torch.empty_like(x)
                                                for x in v)
            times = event_ms(lambda: fused.fused_counting_pass(
                k, v, ak, av, sc, *tables, **kw), 5)
            out[f"d{d}_pass{i}_ms"] = times
            out[f"d{d}_pass{i}_median_ms"] = statistics.median(times)
        del rec
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


def main(argv=None) -> int:
    what = (argv if argv is not None else sys.argv[1:]) or ["merge", "zipf"]
    if not torch.cuda.is_available():
        print("torch_checkout_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in what:
        res = {"merge": merge_times, "zipf": zipf_times, "kv": kv_times,
               "multisplit": multisplit_times, "int64": int64_times,
               "float32": float32_times,
               "histogram": histogram_times, "wide": wide_times,
               "merge_rows": merge_rows_times}[name](dev)
        print(json.dumps({"phase": f"checkout_{name}",
                          "checkout": os.path.basename(os.getcwd()), **res}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
