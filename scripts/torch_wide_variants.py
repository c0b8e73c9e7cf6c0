#!/usr/bin/env python3
"""Times build variants of the wide fused pass's look-back and of
``merge_rows`` against the sources as they are, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_wide_variants.py [--reps 3] [--rounds 3]

It records the fused passes and the first ``merge_rows`` table of
``chip_smoke.py``'s wide-digit cases (2^26 uint32 keys with int32 values
at d = 12, 2^24 keys at d = 16, Table 3's (4,0) config otherwise), builds
each variant from a copy of ``src/repro_torch/kernels/csrc`` with one
setting replaced, and times the variants in turn (``--rounds`` rounds,
alternating their order), each output first checked equal to the
unchanged build's:

* ``fused_pass.cu``: the look-back's two shapes (runs a thread walks at
  once x rows a round, near / far) as they are, and both set to 4 x 4,
  2 x 8 or 8 x 2;
* ``merge_rows.cu``: as it is (int sums for thresholds in (0, 2^25]), and
  with the long long sums for every threshold;

then times ``merge_rows`` as it is on an all-zero table of each recorded
shape.  Prints one JSON line per variant (medians of the rounds' medians,
ms), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)

SHAPES = (r"constexpr int kNearRuns = \d+, kNearRows = \d+;",
          r"constexpr int kFarRuns = \d+, kFarRows = \d+;")
FUSED = {"as_is": None, "all_4x4": (4, 4), "all_2x8": (2, 8),
         "all_8x2": (8, 2)}
MERGE = {"as_is": None, "long_long": True}


def variant_source(text, name, setting):
    if name == "fused_pass" and setting is not None:
        runs, rows = setting
        text = re.sub(SHAPES[0], f"constexpr int kNearRuns = {runs}, "
                      f"kNearRows = {rows};", text)
        text = re.sub(SHAPES[1], f"constexpr int kFarRuns = {runs}, "
                      f"kFarRows = {rows};", text)
    if name == "merge_rows" and setting:
        text = text.replace(
            "if (merge_threshold > 0 && merge_threshold <= (1 << 25))",
            "if (false)")
    return text


def build_variants(root):
    """{(library, variant): path of its shared library}, one nvcc each,
    all started together."""
    from repro_torch.kernels import _build
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    procs, paths = {}, {}
    for name, variants in (("fused_pass", FUSED), ("merge_rows", MERGE)):
        for var, setting in variants.items():
            if setting is None:
                continue
            d = os.path.join(root, f"{name}_{var}")
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            src = os.path.join(d, f"{name}.cu")
            text = open(src).read()
            new = variant_source(text, name, setting)
            if new == text:
                raise RuntimeError(f"variant {name}/{var} changed nothing")
            open(src, "w").write(new)
            out = os.path.join(d, f"{name}.so")
            procs[(name, var)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            paths[(name, var)] = out
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {key} failed to build:\n{log}")
    return paths


def use(name, path):
    """Route the wrapper of library ``name`` to ``path`` (None: the
    unchanged build)."""
    from repro_torch.kernels import _build
    _build._LIBS.pop(name, None)
    _build._FUNCS.pop((name, f"{name}_launch"), None)
    if path is not None:
        lib = ctypes.CDLL(path)
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _build._LIBS[name] = lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import plan
    from repro_torch.core.model import SortConfig
    from repro_torch.kernels import _build, fused
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    paths = build_variants(str(_build.build_dir().parent / "variants"))
    passes, tables = [], []
    for d, below, with_values in chip_smoke.WIDE:
        n = 1 << (28 - below)
        keys = torch.from_numpy(np.random.default_rng(2017 + d).integers(
            0, 2**32, n, dtype=np.uint32)).to(dev)
        vals = (torch.arange(n, dtype=torch.int32, device=dev)
                if with_values else None)
        rec = chip_smoke.capture(torch, keys, vals, passes=8,
                                 cfg=SortConfig(**dict(chip_smoke.D9, d=d)))
        passes += [(f"d{d}_pass{i}", r) for i, r in enumerate(rec["passes"])]
        tables.append((f"d{d}_merge0", rec["merge"][0]))
        del keys, vals, rec

    def run_pass(r):
        alt_k = torch.full_like(r["src_keys"], -1)
        alt_v = tuple(torch.zeros_like(v) for v in r["src_vals"])
        return fused.fused_counting_pass(r["src_keys"], r["src_vals"], alt_k,
                                         alt_v, r["sc"], *r["tables"],
                                         **r["kw"])

    def flat(o):   # keys, every value leaf, the histograms
        return (o[0], *o[1], *o[2:])

    want_p = {label: [t.clone() for t in flat(run_pass(r))]
              for label, r in passes}
    want_m = {label: plan.merge_rows(*t) for label, t in tables}
    cases = [("fused_pass", FUSED, passes, run_pass, want_p),
             ("merge_rows", MERGE, tables, lambda t: plan.merge_rows(*t),
              want_m)]
    for name, variants, items, fn, want in cases:
        times = {v: {label: [] for label, _ in items} for v in variants}
        order = list(variants)
        for rnd in range(args.rounds):
            for var in order if rnd % 2 == 0 else order[::-1]:
                use(name, paths.get((name, var)))
                for label, item in items:
                    got = fn(item)
                    got = flat(got) if name == "fused_pass" else got
                    torch.cuda.synchronize()
                    chip_smoke.need(all(torch.equal(a, b) for a, b in
                                        zip(got, want[label])),
                                    f"{name} variant {var} != as is")
                    times[var][label].append(chip_smoke.cuda_ms(
                        torch, lambda: fn(item), args.reps))
        use(name, None)
        for var in variants:
            chip_smoke.emit({"phase": "wide_variant", "kernel": name,
                             "variant": var, "ms": {
                                 label: statistics.median(t)
                                 for label, t in times[var].items()}})
    for label, (hist, lt, mt) in tables:
        zero = torch.zeros_like(hist)
        chip_smoke.emit({"phase": "merge_rows_zero_table", "table": label,
                         "shape": list(hist.shape),
                         "ms": chip_smoke.cuda_ms(torch, lambda: plan.merge_rows(
                             zero, lt, mt), args.reps * 3)})
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
