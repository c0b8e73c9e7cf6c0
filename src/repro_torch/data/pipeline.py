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

``SyntheticLMData`` is the trainer's restart-exact token stream: batch t
is a pure function of (seed, t).  The reference draws it with
``jax.random``'s threefry2x32 in its partitionable layout (jax 0.9.0's
default): ``PRNGKey``, ``fold_in``, ``split``, 32-bit random bits, then
``uniform`` and ``normal``.  The port computes the same generator with
torch integer ops on int64 lanes masked to 32 bits (this torch has no
uint32 ``>>``), so its bits and its uniforms equal the reference's, on the
CPU and on the card alike.  The tokens ``int32(vocab ** u - 1)`` take
``vocab ** u`` as a float64 power rounded to float32 (correctly rounded,
so the same on every device); XLA's float32 power differs from it in
about 0.06 % of values, which moves a token by one only where the value
straddles an integer.  The patches take ``torch.erfinv`` for XLA's
``erf_inv`` (float32 rounding apart).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import interop
from repro_torch.core.segmented import counting_partition


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds), as ``jax._src.prng``'s lowering: keys and
    counts are Python ints or int64 tensors holding uint32 values; returns
    the two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    return (seed >> 32) & _M32, seed & _M32


def _fold_in(key, data: int):
    """``jax.random.fold_in``: threefry of the counts (0, data)."""
    return _threefry2x32(key[0], key[1], 0, data & _M32)


def _split2(key):
    """``jax.random.split(key)`` (two keys, the partitionable layout: the
    hash of the counts (0, i) gives key i)."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(2)]


def _random_bits(key, shape, device):
    """32-bit random bits of ``shape`` as int64 (partitionable layout: the
    two words of the hash of each element's 64-bit index, XORed)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def _uniform(key, shape, minval: float, maxval: float, device):
    """``jax.random.uniform`` (float32): 23 mantissa bits ORed into 1.0,
    minus 1, scaled to [minval, maxval), at least minval.  XLA fuses the
    scale's multiply and add (one rounding); here both run in float64,
    where they are exact, and round once to float32."""
    bits = (_random_bits(key, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    fused = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, fused)


def _normal(key, shape, device):
    """``jax.random.normal`` (float32): sqrt(2)·erfinv of a uniform on
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = _uniform(key, shape, lo, 1.0, device)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


@dataclasses.dataclass
class SyntheticLMData:
    """Deterministic synthetic token stream: batch(step) is pure in (seed,
    step).  Batches are made on ``device`` (the GPU unless the caller says
    otherwise; without one the first batch raises)."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_patches: int = 0          # vlm stub: also emit patch embeddings
    d_model: int = 0
    device: Optional[str] = None

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        dev = interop.resolve_device(self.device)
        key = _fold_in(_prng_key(self.seed), step)
        # zipfian-ish token marginals: realistic softmax targets
        k1, k2 = _split2(key)
        u = _uniform(k1, (self.global_batch, self.seq_len), 1e-6, 1.0, dev)
        pw = torch.pow(float(self.vocab), u.to(torch.float64)).to(
            torch.float32)
        tokens = torch.clamp((pw - 1.0).to(torch.int32), 0, self.vocab - 1)
        out = {"tokens": tokens}
        if self.num_patches:
            out["patches"] = _normal(
                k2, (self.global_batch, self.num_patches, self.d_model),
                dev) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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


# --- contract declaration (verified by repro_torch.analysis; see
# analysis/contracts)
# Length bucketing partitions ids into 256 buckets with ONE counting pass
# (prologue histogram + fused launch), iota payload as the value leaf — the
# data-pipeline consumer of the same partition primitive.
ANALYSIS_CONTRACT = {
    "entry": "repro_torch.core.segmented.counting_partition",
    "census": {
        "launch_total": "2",
        "while_body_launches": "[]",
        "fused_grid": "ceil_div(g_max, B)",
    },
    "sort_free": True,
    "donation": {"_fused_pass_kernel": "1 + vals"},
    "transfer": {
        "sweep_kernels": ["_hist_kernel", "_fused_pass_kernel"],
        "bytes": "(2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb",
    },
}
