"""Collective bytes-on-wire for the roofline's third term: the port's
counterpart of ``repro.utils.hlo.collective_bytes`` / ``collective_counts``.

Torch has no partitioned HLO to parse.  :class:`CollectiveMode` is a
dispatch mode that sees every collective as it is launched (the functional
``_c10d_functional`` ops that DTensor's redistributions call, DTensor's
``shard_dim_alltoall``, and the ``c10d`` ops behind ``torch.distributed``'s
own calls), with its tensor sizes and its group's size P, and weights it
by the reference's wire factors:

  all-gather          out * (P-1)/P     (each rank receives P-1 shards)
  reduce-scatter      in  * (P-1)/P
  all-reduce          2 * size * (P-1)/P  (ring = RS + AG)
  all-to-all          size * (P-1)/P    (with split sizes: the rows that
                                         leave this rank)
  collective-permute  size              (one hop: a point-to-point send)

It returns ``NotImplemented`` for DTensor operands, so DTensor runs first
and the mode sees the collectives it launches, at the local (per-rank)
shapes: the sums are per-rank wire bytes, as the reference's are per chip.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

def wire_bytes(kind: str, nbytes: float, p: int) -> float:
    """Per-rank wire bytes of one collective of ``kind`` over ``p`` ranks
    whose size (the factor's ``out`` / ``in`` / ``size``) is ``nbytes``."""
    frac = (p - 1) / p
    if kind == "all-reduce":
        return 2 * nbytes * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * frac
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


def _group_size(name) -> int:
    return _resolve_process_group(name).size()


def _all_to_all(inp, in_splits, group_size, rank) -> float:
    """Bytes leaving this rank: every row not addressed to itself."""
    if not in_splits:
        return wire_bytes("all-to-all", _nbytes(inp), group_size)
    row = _nbytes(inp) / max(inp.shape[0], 1)
    return row * (sum(in_splits) - in_splits[rank])


def _rank(group) -> int:
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return group.rank()


def _classify(func, args, out):
    """(kind, per-rank wire bytes) of a collective op, or None."""
    name = str(func.overloadpacket)
    fn = name.split(".")[-1]
    if name.startswith("_c10d_functional."):
        if fn == "all_gather_into_tensor":
            return "all-gather", wire_bytes("all-gather", _nbytes(out),
                                            args[1])
        if fn == "reduce_scatter_tensor":
            return "reduce-scatter", wire_bytes(
                "reduce-scatter", _nbytes(args[0]), args[2])
        if fn == "all_reduce":
            return "all-reduce", wire_bytes("all-reduce", _nbytes(args[0]),
                                            _group_size(args[2]))
        if fn == "all_to_all_single":
            return "all-to-all", _all_to_all(args[0], args[2],
                                             _group_size(args[3]),
                                             _rank(args[3]))
        return None
    if name == "_dtensor.shard_dim_alltoall":
        return "all-to-all", wire_bytes("all-to-all", _nbytes(args[0]),
                                        _group_size(args[3]))
    if name.startswith("c10d."):
        # (the size operand, its position's process group) per c10d op
        where = {"_allgather_base_": (args[0], 2), "allgather_": (args[0], 2),
                 "_reduce_scatter_base_": (args[1], 2),
                 "reduce_scatter_": (args[1], 2), "allreduce_": (args[0], 1),
                 "alltoall_base_": (args[1], 2), "send": (args[0], 1)}
        if fn not in where:
            return None
        t, at = where[fn]
        pg = torch.distributed.ProcessGroup.unbox(args[at])
        if fn == "alltoall_base_":
            return "all-to-all", _all_to_all(t, args[4], pg.size(), pg.rank())
        kind = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_": "reduce-scatter", "allreduce_": "all-reduce",
                "send": "collective-permute"}[fn]
        return kind, wire_bytes(kind, _nbytes(t), pg.size())
    return None


class CollectiveMode(TorchDispatchMode):
    """Counts the collectives launched while it is active: per kind, the
    number of sites and their per-rank wire bytes
    (:func:`collective_counts` / :func:`collective_bytes` read them).
    :meth:`on_op` sees every other op, for subclasses that count more."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented              # DTensor runs its comms
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.OpOverload):
            hit = _classify(func, args, out)
            if hit is not None:
                kind, wire = hit
                self.counts[kind] += 1
                self.bytes[kind] += wire
            else:
                self.on_op(func, args, kwargs or {}, out)
        return out

    def on_op(self, func, args, kwargs, out) -> None:
        """Called for every op that is not a collective."""


def collective_bytes(mode: CollectiveMode) -> Dict[str, float]:
    """Per-rank wire bytes by collective kind (+ 'total')."""
    out = {k: v for k, v in mode.bytes.items() if mode.counts[k]}
    out["total"] = sum(out.values())
    return out


def collective_counts(mode: CollectiveMode) -> Dict[str, int]:
    """Collective sites by kind."""
    return {k: v for k, v in mode.counts.items() if v}
