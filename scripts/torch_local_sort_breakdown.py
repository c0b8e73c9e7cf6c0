#!/usr/bin/env python3
"""Where the port's local sort spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_local_sort_breakdown.py [--log2n 28] [--reps 3]

It records the local-sort classes of ``repro_torch.hybrid_sort`` on
2^log2n uniform uint32 keys with int32 values (``chip_smoke.capture``),
then times ``sort_segments_stable`` over every class in variants: the main
path's leaf mode ("full"), no value leaf moved ("no_leaf_move"), positions
written in place of the leaf ("perm"), a fixed window of the low 16 bits
(two digit passes) in place of each bucket's live-bit window
("fixed_window16"), and one CTA per row in place of the persistent grid
("non_persistent"); and each class's kernel time on the device in the
main path's mode, from a profiled run ("device_class_ms").  Only "full"
and "perm" are sorts of these buckets in general (``chip_smoke.py`` holds
both to the plain version); the variants' outputs are not checked.  Prints one JSON line per variant (the total and
each class's milliseconds), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)


def device_class_ms(torch, rec, buf, leaves, reset):
    """Each class's kernel time on the device (``torch.profiler``), without
    the host's launch cost that the event times of a lone launch include."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bitonic
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for starts, sizes, length in rec["classes"]:
            bitonic.sort_segments_stable(buf, None, starts, sizes, length,
                                         leaves)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events()
               if ev.name.startswith("void segments_kernel")]
    kernels.sort(key=lambda ev: ev.time_range.start)
    return [ev.time_range.elapsed_us() / 1e3 for ev in kernels]


def breakdown(torch, rec, reps):
    from repro_torch.kernels import bitonic
    n = rec["buf"].shape[0]
    buf = rec["buf"].clone()
    leaves = tuple(v.clone() for v in rec["leaves"])
    perm = torch.empty(n, dtype=torch.int32, device=buf.device)
    cases = {"full": {}, "no_leaf_move": dict(leaves=()),
             "perm": dict(leaves=(), perm=perm),
             "fixed_window16": dict(window_bits=16),
             "non_persistent": dict(ctas=True)}

    def reset():
        buf.copy_(rec["buf"])
        for a, b in zip(leaves, rec["leaves"]):
            a.copy_(b)

    out = {"device_class_ms": device_class_ms(torch, rec, buf, leaves,
                                              reset)}
    for name, case in cases.items():
        per_class = []
        for starts, sizes, length in rec["classes"]:
            kw = dict(window_bits=case.get("window_bits", 0),
                      ctas=sizes.numel() if case.get("ctas") else 0)
            per_class.append(chip_smoke.cuda_ms(
                torch, lambda: bitonic.sort_segments_stable(
                    buf, case.get("perm"), starts, sizes, length,
                    case.get("leaves", leaves), **kw), reps, setup=reset))
        out[name] = dict(total_ms=sum(per_class), class_ms=per_class)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_local_sort_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    n = 1 << args.log2n
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    rec = chip_smoke.capture(torch, keys, vals)
    chip_smoke.emit({"phase": "local_sort_breakdown", "n": n,
                     "classes": [c[2] for c in rec["classes"]],
                     "live_rows": [int((c[1] > 0).sum())
                                   for c in rec["classes"]],
                     **breakdown(torch, rec, args.reps)})
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
