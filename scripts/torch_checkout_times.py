#!/usr/bin/env python3
"""Times a checkout's own package on one NVIDIA GPU, for comparing two
checkouts (a parent and a change) in one call to the card.

Run from the root of the checkout whose package is timed (its ``src/``
comes first on the path), naming this script by its path:

    cd <checkout> && python3 <repo>/scripts/torch_checkout_times.py [merge] [zipf] [kv]

``merge`` times ``kway_merge_round`` on ``chip_smoke.py``'s out-of-core
round (4 sorted runs of 2^28 uniform uint32 keys, an int32 index leaf,
kway 4) at tiles 4096 and 256 and checks the output is sorted; ``zipf``
times ``hybrid_sort`` on ``chip_smoke.py``'s Zipf(1.5) 2^26 uint32 keys
and ``kv`` on 2^28 uniform uint32 keys with an int32 index (the main
path's KV case), outside that script's run.  Medians of the timed runs
after a warm-up, CUDA events; one JSON line each.
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


def main(argv=None) -> int:
    what = (argv if argv is not None else sys.argv[1:]) or ["merge", "zipf"]
    if not torch.cuda.is_available():
        print("torch_checkout_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in what:
        res = {"merge": merge_times, "zipf": zipf_times,
               "kv": kv_times}[name](dev)
        print(json.dumps({"phase": f"checkout_{name}",
                          "checkout": os.path.basename(os.getcwd()), **res}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
