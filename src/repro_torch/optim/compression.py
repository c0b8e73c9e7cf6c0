"""Gradient compression for a slow link (port of
``repro.optim.compression``): block-scaled int8, 4x fewer bytes than
float32 at a per-block error of at most max|x|/254.

Hierarchical gradient reduction: reduce-scatter in full precision over the
fast intra-node links, then compress to int8 (block-scaled) for the
reduction across the slow link, then decompress: ``compressed_psum``, over
a process group or one dim of a ``DeviceMesh`` (``launch/mesh.py``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

_BLOCK = 512


def int8_compress(x: torch.Tensor):
    """(q (blocks, 512) int8, scale (blocks, 1) float32): blocks of 512
    float32 values (zero-padded), scale max|x|/127, ``q`` rounded half to
    even."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    fb = F.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = fb.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(fb / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def _process_group(group):
    """A process group from ``group``: a ``ProcessGroup``, a
    ``(DeviceMesh, dim name)`` pair, or None (the default group)."""
    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    return group if group is not None else dist.group.WORLD


def _all_gather_bytes(t: torch.Tensor, pg) -> torch.Tensor:
    """(P, *t.shape) of every rank's ``t`` in rank order, sent as ``uint8``
    views (gloo and NCCL each refuse some dtypes)."""
    b = t.contiguous().view(torch.uint8)
    parts = [torch.empty_like(b) for _ in range(pg.size())]
    dist.all_gather(parts, b, group=pg)
    return torch.stack(parts).view(t.dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """psum over ``group`` with an int8 wire format (use over the slow
    link).

    The payload crossing the link is int8 + per-block float32 scales (~4x
    fewer bytes than a float32 all-reduce for small groups): all-gather the
    quantised blocks, dequantise and sum locally in float32, rank by rank
    in rank order, then cast back to ``x.dtype``.  Quantisation error is
    bounded by the per-block max/127 — measured against the exact sum in
    the tests.  ``group``: a process group, a ``(DeviceMesh, dim name)``
    pair, or None for the default group."""
    pg = _process_group(group)
    q, s = int8_compress(x)
    qs = _all_gather_bytes(q, pg)                   # (P, blocks, 512) int8
    ss = _all_gather_bytes(s, pg)                   # (P, blocks, 1) f32
    summed = qs[0].to(torch.float32) * ss[0]
    for r in range(1, qs.shape[0]):
        summed = summed + qs[r].to(torch.float32) * ss[r]
    return summed.reshape(-1)[: math.prod(x.shape)].reshape(x.shape) \
        .to(x.dtype)
