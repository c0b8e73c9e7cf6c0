"""Sort-based length bucketing: port of ``repro.data.pipeline``.

``length_bucketed_batches`` orders documents by length and packs them into
batches of at most ``batch_tokens`` padded tokens, by one of three routes,
as the reference does:

  * the host LSD route (default): chained 256-bucket
    ``core.segmented.counting_partition`` passes, one per occupied length
    byte (one fused counting pass each on the card);
  * the out-of-core route (``ooc_chunk_elems``): ``core.outofcore.oocsort``
    with the document indices as the value payload, its spill, fault,
    retry and checkpoint options passed through;
  * the distributed route (``dist_mesh``): ``core.distributed``'s sample
    sort over a port mesh, the indices riding as the value payload.

The reference module's other half, ``SyntheticLMData``, is the trainer's
token stream; its tokens come from ``jax.random``'s threefry generator, so
it is ported with the LM substrate, not here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import interop
from repro_torch.core.segmented import counting_partition


def length_bucketed_batches(lengths: np.ndarray, batch_tokens: int,
                            engine: Optional[str] = None,
                            ooc_chunk_elems: Optional[int] = None,
                            ooc_spill_budget_bytes: Optional[int] = None,
                            ooc_device_slab_elems: Optional[int] = None,
                            ooc_fault_policy=None,
                            ooc_retry_policy=None,
                            ooc_checkpoint_dir: Optional[str] = None,
                            dist_mesh=None, device=None):
    """Order documents by length, then pack (the reference's contract).

    The host route runs on ``device`` (the GPU unless the caller passes
    ``"cpu"``; with no GPU it raises), as does the out-of-core route; the
    distributed route runs on ``dist_mesh``'s device, and every rank of a
    process-group mesh passes the same global ``lengths`` and gets the
    whole order back.  ``engine`` goes to the partition, the chunk sorts or
    the shard sorts.

    Returns ``(order, bucket_bounds)``: ``order`` (numpy int32) is the
    stable ascending-length document order, and the bounds delimit batches
    of at most ``batch_tokens`` padded tokens.
    """
    lengths = np.asarray(lengths, np.uint32)
    if ooc_chunk_elems is None and (ooc_spill_budget_bytes is not None or
                                    ooc_device_slab_elems is not None):
        raise ValueError("ooc spill options require ooc_chunk_elems (the "
                         "spill regime is part of the out-of-core route)")
    if ooc_chunk_elems is None and (ooc_fault_policy is not None or
                                    ooc_retry_policy is not None or
                                    ooc_checkpoint_dir is not None):
        raise ValueError("ooc fault/retry/checkpoint options require "
                         "ooc_chunk_elems (resilience wraps the "
                         "out-of-core route)")
    if dist_mesh is not None and ooc_chunk_elems is not None:
        raise ValueError("dist_mesh and ooc_chunk_elems are exclusive "
                         "routes (mesh-sharded vs host-chunked ordering)")
    if dist_mesh is not None:
        sorted_len, order = _dist_order(lengths, dist_mesh, engine)
    elif ooc_chunk_elems is not None:
        from repro_torch.core.outofcore import oocsort
        sorted_len, order = oocsort(
            lengths, ooc_chunk_elems, engine=engine,
            values=np.arange(lengths.shape[0], dtype=np.int32),
            spill_budget_bytes=ooc_spill_budget_bytes,
            device_slab_elems=ooc_device_slab_elems,
            faults=ooc_fault_policy, retry=ooc_retry_policy,
            checkpoint_dir=ooc_checkpoint_dir, device=device)
    else:
        sorted_len, order = _lsd_order(lengths, engine, device)

    bounds = [0]
    cur_max = 0
    cur_n = 0
    for i, ln in enumerate(sorted_len):
        cand_max = max(cur_max, int(ln))
        if cur_n and cand_max * (cur_n + 1) > batch_tokens:
            bounds.append(i)
            cur_max, cur_n = int(ln), 1
        else:
            cur_max, cur_n = cand_max, cur_n + 1
    bounds.append(len(sorted_len))
    return order, bounds


def _lsd_order(lengths: np.ndarray, engine, device):
    """Stable LSD passes, least significant byte first, only as many as
    the longest document needs; lengths and order stay on the device."""
    max_len = int(lengths.max()) if lengths.size else 0
    npasses = max(1, (max_len.bit_length() + 7) // 8)
    x = interop.to_tensor(lengths.astype(np.int64), device)
    order = torch.arange(lengths.shape[0], dtype=torch.int32,
                         device=x.device)
    for p in range(npasses):
        ids = ((x >> (8 * p)) & 0xFF).to(torch.int32)
        perm = counting_partition(ids, 256, engine=engine).perm.to(
            torch.int64)
        x = x[perm]
        order = order[perm]
    return (interop.to_numpy(x).astype(np.uint32),
            interop.to_numpy(order))


def _dist_order(lengths: np.ndarray, mesh, engine):
    """The distributed route: sentinel-pad to a multiple of the shard
    count (pads sort last and are dropped by index, so a real 0xFFFFFFFF
    length still buckets correctly), sort each held shard, then gather
    every shard's padded output and valid count to concatenate the
    global order."""
    from repro_torch.core.distributed import (make_distributed_sort,
                                              valid_concat)
    nshards = mesh.size
    n = lengths.shape[0]
    pad = (-n) % nshards
    keys = np.concatenate(
        [lengths, np.full(pad, np.uint32(0xFFFFFFFF), np.uint32)])
    idx = np.arange(n + pad, dtype=np.int32)
    n_local = (n + pad) // nshards
    # tiny shards: full-fan exchange capacity (slack = nshards caps each
    # cell at the whole chunk), so a small corpus never overflows on
    # per-cell noise; large shards keep the sampled-splitter default
    slack = float(nshards) if n_local < 1024 else 2.0
    held = list(mesh.shards)
    fn = make_distributed_sort(mesh, slack=slack, engine=engine)
    out, order_out, stats = fn(keys.reshape(nshards, -1)[held].reshape(-1),
                               idx.reshape(nshards, -1)[held].reshape(-1))
    if bool(stats.overflow.any()):
        raise RuntimeError("distributed length bucketing overflowed its "
                           "exchange capacity after splitter-refinement "
                           "retries (raise slack= or oversample=)")
    rows = len(held)
    valid = mesh.all_gather(list(stats.valid.reshape(rows, 1)))
    sorted_all, order_all = (interop.to_numpy(valid_concat(
        mesh.all_gather(list(t.view(rows, -1))), valid))
        for t in (out, order_out))
    keep = order_all < n
    return sorted_all[keep], order_all[keep]
