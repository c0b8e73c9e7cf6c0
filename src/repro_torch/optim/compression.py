"""Gradient compression for a slow link (port of
``repro.optim.compression``): block-scaled int8, 4x fewer bytes than
float32 at a per-block error of at most max|x|/254.

``int8_compress`` / ``int8_decompress`` are ported.  The reference's
``compressed_psum`` is a collective over a mesh axis; it comes with the
port's mesh (``launch/mesh.py``), which is not ported yet.
"""
from __future__ import annotations

import math

import torch
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
