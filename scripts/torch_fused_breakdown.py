#!/usr/bin/env python3
"""Where the port's fused counting pass spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_fused_breakdown.py [--log2n 28] [--reps 3] [--wide]

It records the two fused passes of ``repro_torch.hybrid_sort`` on 2^log2n
uniform uint32 keys with int32 values (``chip_smoke.capture``), then times
``fused_counting_pass`` on each with parts of its work switched off through
its arguments: no second next-pass count (lookahead off), no next-pass
count at all (next widths 0), no look-back wait (every row a region
start), no value leaves, and all four off ("minimal").  Those variants'
outputs are not the pass's and are not checked (``chip_smoke.py`` holds
the kernel to its plain version).  With ``--wide`` it takes instead the
passes of ``chip_smoke.py``'s wide-digit cases (2^(log2n - 2) keys with
int32 values at d = 12, 2^(log2n - 4) keys alone at d = 16: the fused
pass's wide variant, where "no look-back wait" leaves every row without a
look-back).  Prints one JSON line per pass, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)


def breakdown(torch, rec, reps):
    from repro_torch.kernels import fused
    kw = rec["kw"]
    lo, width = rec["sc"][:2]
    no_wait = list(rec["tables"])
    no_wait[2] = torch.ones_like(no_wait[2])
    keys, vals = rec["src_keys"], rec["src_vals"]
    cases = {"full": {},
             "no_lookahead": dict(lookahead=False),
             "no_next_hist": dict(sc=(lo, width, 0, 0), lookahead=False),
             "no_lookback_wait": dict(tables=no_wait),
             "keys_only": dict(vals=()),
             "minimal": dict(sc=(lo, width, 0, 0), lookahead=False,
                             tables=no_wait, vals=())}
    out = {}
    for name, case in cases.items():
        v = case.get("vals", vals)
        alt_k = torch.empty_like(keys)
        alt_v = tuple(torch.empty_like(x) for x in v)
        args = (keys, v, alt_k, alt_v, case.get("sc", rec["sc"]),
                *case.get("tables", rec["tables"]))
        ckw = dict(kw, lookahead=case.get("lookahead",
                                          kw.get("lookahead", False)))
        out[name] = chip_smoke.cuda_ms(
            torch, lambda: fused.fused_counting_pass(*args, **ckw), reps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--wide", action="store_true",
                        help="the wide-digit cases (d = 12 and 16)")
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    if args.wide:
        from repro_torch.core.model import SortConfig
        cases = []
        for d, below, with_values in chip_smoke.WIDE:
            n = 1 << (args.log2n - below)
            keys = torch.from_numpy(np.random.default_rng(2017 + d).integers(
                0, 2**32, n, dtype=np.uint32)).to(dev)
            vals = (torch.arange(n, dtype=torch.int32, device=dev)
                    if with_values else None)
            cases.append((f"d{d}", n, keys, vals,
                          SortConfig(**dict(chip_smoke.D9, d=d))))
    else:
        n = 1 << args.log2n
        rng = np.random.default_rng(11)
        keys = torch.from_numpy(rng.integers(0, 2**32, n,
                                             dtype=np.uint32)).to(dev)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        cases = [("kv", n, keys, vals, None)]
    for label, n, keys, vals, cfg in cases:
        rec = chip_smoke.capture(torch, keys, vals, passes=8, cfg=cfg)
        for i, r in enumerate(rec["passes"]):
            chip_smoke.emit({"phase": "fused_breakdown",
                             "pass": f"{label}_pass{i}", "n": n,
                             "ms": breakdown(torch, r, args.reps)})
        del rec, keys, vals
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
