"""Quickstart: the hybrid radix sort public API, on the PyTorch/CUDA port.

The port of ``examples/quickstart.py``: the same keys, calls and lines.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # the CPU

Without a card and without ``--device cpu`` it stops with the port's "no
CUDA device" error before printing anything.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (default_config, expected_speedup,  # noqa: E402
                              hybrid_sort, lsd_sort, memory_budget)
from repro_torch.core.interop import resolve_device  # noqa: E402


# torch neither orders nor indexes unsigned 32-bit tensors on the card:
# uint32 keys are ordered as int64 and indexed and compared through their
# int32 views (the same bits)

def _sorted(t: torch.Tensor) -> bool:
    """Non-decreasing?"""
    if t.dtype == torch.uint32:
        t = t.to(torch.int64)
    return bool((t[1:] >= t[:-1]).all())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def run(device=None, n=1 << 18, n_floats=100_000) -> dict:
    """The quickstart; returns the two sorts' ``SortStats``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # --- sort keys of any primitive dtype ----------------------------------
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(
        dev)
    out, stats = hybrid_sort(keys, return_stats=True)
    print(f"u32 uniform: sorted={_sorted(out)} "
          f"counting_passes={int(stats.counting_passes)} (of 4 worst-case) "
          f"local_sort={bool(stats.used_local_sort)}")

    floats = torch.from_numpy(
        rng.standard_normal(n_floats).astype(np.float32)).to(dev)
    print("f32:", bool((hybrid_sort(floats)[1:] >=
                        hybrid_sort(floats)[:-1]).all()))

    # --- key-value pairs (decomposed layout, §4.6) --------------------------
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)
    sk, sv = hybrid_sort(keys, vals)
    print("pairs move together:", bool((_bits(keys)[sv] == _bits(sk)).all()))

    # --- skewed distributions: the MSD design is what keeps this fast -------
    skewed = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                              & rng.integers(0, 2**32, n, dtype=np.uint32)
                              ).to(dev)
    _, st2 = hybrid_sort(skewed, return_stats=True)
    print(f"skewed: passes={int(st2.counting_passes)}")

    # --- the CUB-style LSD baseline the paper compares against --------------
    assert bool((_bits(lsd_sort(keys, d=5)) == _bits(out)).all())
    print("lsd(d=5) agrees with hybrid")

    # --- the paper's analytical model (§4.5) -------------------------------
    cfg = default_config(4)
    b = memory_budget(500_000_000, 32, cfg)
    print(f"aux memory for 2GB of u32: {b['aux_over_m1']*100:.1f}% of input "
          f"(paper: <5%); expected speedup vs LSD-5: "
          f"{expected_speedup(32):.2f}x")
    return {"uniform": stats, "skewed": st2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the sorts run (default: the card)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
