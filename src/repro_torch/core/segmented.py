"""Counting-sort partitioning primitives reused across the framework: port
of ``repro.core.segmented``.

``counting_partition`` is one hybrid-radix counting pass (paper §4.1 steps
1–3) exposed as a standalone op, a thin client of
``core.plan.single_pass_partition``.  It is the core of:

  * MoE token dispatch (group tokens expert-major; E <= 2^d ⇒ one pass),
  * data-pipeline length bucketing,
  * the shard-partitioning step of the distributed sort (§5).

``engine=None`` resolves as the sorts do: the fused ``kernel`` launch on
CUDA, ``argsort`` on the CPU.

``merge_sorted`` and ``multiway_merge`` are the reference's merge by
vectorised binary search, which it computes outside any Pallas kernel; the
port computes them with ``torch.searchsorted`` and scatters, over keys
mapped to signed integers in the order of the reference's
``jnp.searchsorted`` (unsigned keys through ``bijection.sortable``; floats
with every zero equal and every NaN equal and last, as XLA's sort
comparator takes them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import bijection, plan
from repro_torch.core.hybrid import _MOVABLE

_I32 = torch.int32


class Partition(NamedTuple):
    dest: torch.Tensor     # (m,) slot of element i in bucket-major order
    perm: torch.Tensor     # (m,) gather order: sorted[j] = x[perm[j]]
    counts: torch.Tensor   # (num_buckets,)
    offsets: torch.Tensor  # (num_buckets,) exclusive prefix of counts


def counting_partition(bucket_ids: torch.Tensor, num_buckets: int,
                       engine: Optional[str] = None) -> Partition:
    """Stable partition of elements by ``bucket_ids`` (one counting pass)."""
    dest, perm, counts = plan.single_pass_partition(
        bucket_ids, num_buckets, engine=engine)
    offsets = (torch.cumsum(counts, 0, dtype=_I32) - counts).to(_I32)
    return Partition(dest=dest, perm=perm, counts=counts, offsets=offsets)


class CapacityDispatch(NamedTuple):
    """Bucket-major, capacity-padded gather layout (the MoE dispatch
    shape)."""
    gather_idx: torch.Tensor   # (num_buckets, capacity) source element/slot
    slot_valid: torch.Tensor   # (num_buckets, capacity) bool
    position: torch.Tensor     # (m,) element's slot within its bucket
    kept: torch.Tensor         # (m,) bool — False if dropped by capacity
    counts: torch.Tensor       # (num_buckets,)


def capacity_dispatch(bucket_ids: torch.Tensor, num_buckets: int,
                      capacity: int,
                      engine: Optional[str] = None) -> CapacityDispatch:
    """Counting-sort dispatch into a dense (buckets, capacity) layout.

    The paper's scatter step with each bucket's destination chunk reserved
    (§4.4), here as the static capacity row.  Elements beyond capacity are
    dropped (standard MoE semantics): they go to the trash entry
    ``num_buckets · capacity``, which is cut off.
    """
    m = bucket_ids.shape[0]
    dev = bucket_ids.device
    part = counting_partition(bucket_ids, num_buckets, engine=engine)
    ids = bucket_ids.to(torch.int64)
    position = part.dest - part.offsets[ids]
    kept = position < capacity
    trash = num_buckets * capacity
    slot = torch.where(kept, ids * capacity + position, trash)
    # the reference's scatter drops indices past the table
    slot = torch.where((slot >= 0) & (slot <= trash), slot, trash)
    gather_flat = torch.full((trash + 1,), m, dtype=_I32, device=dev)
    gather_flat[slot] = torch.arange(m, dtype=_I32, device=dev)
    gather_idx = gather_flat[:-1].reshape(num_buckets, capacity)
    return CapacityDispatch(gather_idx=gather_idx, slot_valid=gather_idx < m,
                            position=position.to(_I32), kept=kept,
                            counts=part.counts)


def search_order(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the reference's ``jnp.searchsorted``
    order of ``x``: integers by value, floats with -0 equal to +0 and every
    NaN equal and above +inf."""
    if x.dtype.is_floating_point:
        x = torch.where(x == 0, torch.zeros_like(x), x)
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        x = bijection.sortable(bijection.to_ordered_bits(x))
    elif x.dtype in _MOVABLE:
        x = bijection.sortable(bijection.to_ordered_bits(x))
    return x.to(torch.int64)


def _scatter(pos_a, a, pos_b, b):
    """``a`` at ``pos_a`` and ``b`` at ``pos_b`` of one new array (uint16/32/
    64 scattered as their signed twins)."""
    dt = a.dtype
    mv = _MOVABLE.get(dt, dt)
    out = torch.zeros(a.shape[0] + b.shape[0], dtype=mv, device=a.device)
    out[pos_a] = a.view(mv)
    out[pos_b] = b.to(dt).view(mv)
    return out.view(dt)


def merge_sorted(a: torch.Tensor, b: torch.Tensor, va=None, vb=None):
    """Merge of two sorted arrays by vectorised binary search (the GPU
    merge-path analogue, §5's multiway-merge building block): ties keep
    ``a`` before ``b``; optional values ride along (§4.6 pair
    semantics)."""
    na, nb = a.shape[0], b.shape[0]
    oa, ob = search_order(a), search_order(b)
    pos_a = (torch.arange(na, device=a.device) +
             torch.searchsorted(ob, oa, side="left"))
    pos_b = (torch.arange(nb, device=b.device) +
             torch.searchsorted(oa, ob, side="right"))
    merged = _scatter(pos_a, a, pos_b, b)
    if va is None:
        return merged
    return merged, _scatter(pos_a, va, pos_b, vb)


def multiway_merge(runs: torch.Tensor, values=None):
    """Merge (s, run_len) sorted runs by pairwise reduction (log2 s
    passes); optional (s, run_len) values permute alongside."""
    s = runs.shape[0]
    flat = [runs[i] for i in range(s)]
    vals = [values[i] for i in range(s)] if values is not None else None
    while len(flat) > 1:
        nxt, vnxt = [], []
        for i in range(0, len(flat) - 1, 2):
            if vals is None:
                nxt.append(merge_sorted(flat[i], flat[i + 1]))
            else:
                m, vm = merge_sorted(flat[i], flat[i + 1], vals[i],
                                     vals[i + 1])
                nxt.append(m)
                vnxt.append(vm)
        if len(flat) % 2:
            nxt.append(flat[-1])
            if vals is not None:
                vnxt.append(vals[-1])
        flat = nxt
        if vals is not None:
            vals = vnxt
    return flat[0] if values is None else (flat[0], vals[0])
