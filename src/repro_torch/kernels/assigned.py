"""Descriptor-driven histogram: port of
``repro.kernels.assigned.assigned_histogram``.

Grid slot g histograms tile ``tile_idx[g]`` of the (T, KPB) keys and
multiplies the row by ``valid[g]``: the launch pattern of paper §4.2, where
a constant number of blocks each read their own assignment from a table.
On a CUDA tensor it launches the ``assigned`` entry of
``csrc/histogram.cu`` (one CTA per slot loads its own descriptor from
global memory, in place of the TPU's scalar prefetch, and counts its tile
as the prologue histogram counts: 16-byte loads, register runs of equal
digits, shared tables; widths 1..16); on a CPU tensor it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.histogram import check_width

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P]


def assigned_histogram(keys: torch.Tensor, tile_idx: torch.Tensor,
                       valid: torch.Tensor, shift: int,
                       width: int) -> torch.Tensor:
    """(T, KPB) integer keys, (G,) int32 ``tile_idx`` and ``valid`` ->
    (G, 2^width) int32: row g is tile ``tile_idx[g]``'s histogram times
    ``valid[g]`` (0 gives a zero row).  As in the reference, an index in
    [-T, -1] counts from the end and any index is then clamped to
    [0, T-1]."""
    if _build.on_cpu(keys):
        out = ref.assigned_histogram_ref(keys, tile_idx, valid, shift, width)
        if _build.RECORDER is not None and tile_idx.shape[0]:
            _build.RECORDER.launch("_assigned_hist_kernel", plain=True,
                                   reads=(keys,), writes=(out,),
                                   tables=tuple(tile_idx.shape))
        return out
    check_width(width)
    b, logical = ref.signed_bits(keys.contiguous())
    t, kpb = b.shape
    g = tile_idx.shape[0]
    if valid.shape != (g,):
        raise ValueError("tile_idx and valid must both be (G,)")
    if t == 0 or kpb == 0:
        raise ValueError("assigned_histogram needs at least one non-empty "
                         "tile")
    tile_idx = tile_idx.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    out = torch.empty((g, 1 << width), dtype=torch.int32, device=b.device)
    _build.check_cuda(b, tile_idx, valid, out)
    if g == 0:
        return out
    fn = _build.function("histogram", "assigned_histogram_launch", _ARGS)
    with torch.cuda.device(b.device):
        rc = fn(_build.ptr(b), b.element_size(), t, kpb,
                _build.ptr(tile_idx), _build.ptr(valid), g, shift, width,
                int(logical), _build.ptr(out),
                _build.stream_handle(b.device))
    _build.check("histogram", rc)
    _build.COUNTS["assigned_hist"] += 1
    if _build.RECORDER is not None:
        _build.RECORDER.launch("_assigned_hist_kernel", plain=False,
                               reads=(keys,), writes=(out,),
                               tables=tuple(tile_idx.shape))
    return out
