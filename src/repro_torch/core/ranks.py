"""Stable-partition rank/permutation engines for counting-sort passes.

Port of ``repro.core.ranks``.  A counting pass needs, for every key, its
destination slot: keys grouped by bucket id with ties broken by input
position (stable within a pass).  Two plain-torch engines compute it:

  * ``argsort`` — one ``torch.sort(stable=True)`` of the bucket ids;
  * ``scan``    — the O(n) two-level scheme: per-chunk histograms, in-chunk
    ranks and a carried running histogram across chunks.

The third engine name, ``kernel``, selects the hand-written CUDA kernels
(``repro_torch.kernels``); on a CPU tensor it runs their plain versions.
Both engines here return ``dest``: element i moves to slot ``dest[i]``.
"""
from __future__ import annotations

import torch

#: Engines understood by the sort entry points.
ENGINES = ("argsort", "scan", "kernel")


def resolve_engine(engine=None, device=None) -> str:
    """Resolve ``None``/``"auto"`` for the device the work runs on.

    ``auto`` is ``kernel`` on a CUDA device and ``argsort`` on the CPU.  An
    explicit engine is always honoured: ``kernel`` on a CPU tensor runs the
    kernels' plain versions, and on CUDA a kernel that fails to build or
    launch raises — there is no demotion to another engine.
    """
    if engine in (None, "auto"):
        device = torch.device(device if device is not None else "cpu")
        return "kernel" if device.type == "cuda" else "argsort"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return engine


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """dest such that dest[perm[j]] = j (int32)."""
    n = perm.shape[0]
    dest = torch.empty(n, dtype=torch.int32, device=perm.device)
    dest[perm] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return dest


def stable_partition_dest_argsort(bucket: torch.Tensor) -> torch.Tensor:
    """Destination slots of a stable partition by ``bucket``."""
    perm = torch.sort(bucket, stable=True).indices
    return invert_permutation(perm)


def stable_partition_dest_scan(bucket: torch.Tensor, num_buckets: int,
                               chunk: int = 2048) -> torch.Tensor:
    """O(n) counting-rank engine: chunked ranks with a carried histogram."""
    n = bucket.shape[0]
    dev = bucket.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    pad = (-n) % chunk
    nb = num_buckets + 1                      # one trash bucket for padding
    b = torch.cat([bucket.to(torch.int64),
                   torch.full((pad,), num_buckets, dtype=torch.int64,
                              device=dev)])
    tiles = b.reshape(-1, chunk)
    t = tiles.shape[0]
    row = torch.arange(t, device=dev).unsqueeze(1)
    hists = torch.zeros(t * nb, dtype=torch.int32, device=dev)
    hists.index_add_(0, (row * nb + tiles).reshape(-1),
                     torch.ones(t * chunk, dtype=torch.int32, device=dev))
    hists = hists.reshape(t, nb)
    total = hists.sum(0, dtype=torch.int32)
    g_off = torch.cumsum(total, 0, dtype=torch.int32) - total
    carry = torch.cumsum(hists, 0, dtype=torch.int32) - hists   # (T, nb)
    if nb <= 4096:
        onehot = (tiles.unsqueeze(2) ==
                  torch.arange(nb, device=dev)).to(torch.int32)
        excl = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
        in_tile = torch.gather(excl, 2, tiles.unsqueeze(2)).squeeze(2)
    else:
        # wide bucket spaces: count equal predecessors pairwise in the chunk
        i = torch.arange(chunk, device=dev)
        eq_before = ((tiles.unsqueeze(1) == tiles.unsqueeze(2)) &
                     (i.unsqueeze(0) < i.unsqueeze(1)))
        in_tile = eq_before.sum(2, dtype=torch.int32)
    dest = g_off[tiles] + torch.gather(carry, 1, tiles) + in_tile
    return dest.reshape(-1)[:n].to(torch.int32)


def stable_partition_dest(bucket: torch.Tensor, num_buckets: int,
                          engine: str = "argsort") -> torch.Tensor:
    if engine == "argsort":
        return stable_partition_dest_argsort(bucket)
    if engine == "scan":
        # wide bucket spaces take the pairwise in-chunk path: shrink the chunk
        chunk = 2048 if num_buckets <= 4096 else 256
        return stable_partition_dest_scan(bucket, num_buckets, chunk=chunk)
    raise ValueError(f"unknown rank engine {engine!r}")
