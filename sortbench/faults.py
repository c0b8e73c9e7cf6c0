"""Faults planted under the timed path.  Each breaks one thing a sort can
get wrong, and a run with any of them in place has to come out not
correct (``tests/test_sortbench_faults.py``; on the card, ``control.py
--fault``)."""
from __future__ import annotations

import torch

from sortbench.generate import SIGNED


def _clone(inp: dict) -> dict:
    return {k: v.clone() for k, v in inp.items()}


def unchanged(call):
    """The call hands back its input as it found it."""
    return lambda inp, config: _clone(inp)


def half(call):
    """Half of the records left out of the sort: the first half is sorted,
    the second handed back as it came."""
    def broken(inp, config):
        n = inp["keys"].numel()
        head = call({k: v[:n // 2] for k, v in inp.items()}, config)
        return {k: torch.cat([head[k], inp[k][n // 2:]]) for k in head}
    return broken


def altered(call):
    """One answer altered where it is produced: the lowest bit of one
    record's value (of its key where there are no values) flipped."""
    def broken(inp, config):
        out = call(inp, config)
        name = "values" if "values" in out else "keys"
        col = out[name]
        bits = col.view(SIGNED.get(col.dtype, col.dtype))
        bits[col.numel() // 3] ^= 1
        return out
    return broken


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
