"""Digit histograms: port of ``repro.kernels.histogram.radix_histogram``
(and, in ``assigned.py``, of ``assigned_histogram``).

On a CUDA tensor the wrappers launch ``csrc/histogram.cu`` (per-warp
sub-histograms in shared memory with warp-merged increments, the paper's
Fig. 2 fix for skew); on a CPU tensor they run the plain version in
``ref.py``.  Keys are any integer dtype; digits use the dtype's own shift
(logical for unsigned keys).  Digit widths 1..8 only on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
#: keys per CTA floor of the whole-array total (keeps the CTA count modest)
_TOTAL_MIN_CHUNK = 1 << 15
_TOTAL_MAX_CTAS = 4096


def check_width(width: int) -> None:
    if not 1 <= width <= 8:
        raise ValueError(f"the CUDA histogram supports digit widths 1..8, "
                         f"got {width}")


def _launch(keys, n, chunk, grid, shift, width, out, accumulate,
            logical=False):
    check_width(width)
    keys, unsigned = ref.signed_bits(keys)
    logical = logical or unsigned
    _build.check_cuda(keys, out)
    fn = _build.function("histogram", "radix_histogram_launch", _ARGS)
    with torch.cuda.device(keys.device):
        rc = fn(_build.ptr(keys), n, keys.element_size(), chunk, grid, shift,
                width, int(logical), _build.ptr(out), accumulate,
                _build.stream_handle(keys.device))
    _build.check("histogram", rc)
    _build.COUNTS["histogram"] += 1


def radix_histogram(keys: torch.Tensor, shift: int,
                    width: int) -> torch.Tensor:
    """(T, KPB) integer keys -> (T, 2^width) int32 per-tile histograms."""
    if _build.on_cpu(keys):
        return ref.radix_histogram_ref(keys, shift, width)
    t, kpb = keys.shape
    out = torch.empty((t, 1 << width), dtype=torch.int32, device=keys.device)
    if t:
        _launch(keys, t * kpb, kpb, t, shift, width, out, 0)
    return out


def digit_total(keys: torch.Tensor, n: int, shift: int,
                width: int) -> torch.Tensor:
    """(2^width,) int32 digit counts over ``keys[:n]`` of a 1-D carrier
    buffer (unsigned bits in a signed dtype: digits shift logically).

    The main path's prologue: the sum over tiles of ``radix_histogram``,
    computed without the (T, r) rows — each CTA adds its counts into one
    total.
    """
    if _build.on_cpu(keys):
        return ref.radix_histogram_ref(keys[:n].reshape(1, -1), shift,
                                       width)[0]
    out = torch.zeros(1 << width, dtype=torch.int32, device=keys.device)
    if n:
        chunk = max(_TOTAL_MIN_CHUNK, -(-n // _TOTAL_MAX_CTAS))
        chunk = -(-chunk // 32) * 32
        _launch(keys, n, chunk, -(-n // chunk), shift, width, out, 1,
                logical=True)
    return out
