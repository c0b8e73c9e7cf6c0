"""Tile multisplit: port of ``repro.kernels.multisplit.tile_multisplit`` and
``tile_multisplit_kv`` (paper §4.4's shared-memory write combining, §4.6's
pairs).

Per (KPB,) tile: the keys (and values) stably reordered digit-major, each
output slot's digit and rank in its digit run, and the tile's histogram.
On a CUDA tensor the wrappers launch ``csrc/multisplit.cu`` (one CTA per
tile, stable in-block ranks, the tile staged digit-major in shared memory
and written out coalesced); on a CPU tensor they run the plain version in
``ref.py``.

Keys and values take their own dtype: uint16, int32, uint32, int64 or
uint64, the dtypes the reference's 16-bit-half round trip accepts.  As
there, only the low ``16 * ceil(key_bits / 16)`` key bits (``val_bits``
for values) come back, and digits use the key dtype's own shift.  Digit
widths 1..8 on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.histogram import check_width

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_ulonglong
_ARGS = [_P] * 7 + [_I] * 7 + [_U64, _U64, _P]
#: the opt-in shared memory one CTA may use on Hopper
SMEM_LIMIT = 232448
_WARPS = 16


def smem_bytes(kpb: int, key_bytes: int, val_bytes: int, width: int) -> int:
    """Shared memory of one CTA of ``csrc/multisplit.cu``: the staged keys,
    values and digits of the tile plus the per-warp digit table."""
    def a8(n):
        return -(-n // 8) * 8
    return (a8(kpb * key_bytes) + (a8(kpb * val_bytes) if val_bytes else 0) +
            4 * (_WARPS + 1) * (1 << width) + kpb)


def _split(keys, vals, shift, width, key_bits, val_bits):
    if _build.on_cpu(keys):
        return ref.tile_multisplit_kv_ref(keys, vals, shift, width, key_bits,
                                          val_bits)
    check_width(width, 8)
    ref.check_multisplit_dtypes(keys, vals)
    b, logical = ref.signed_bits(keys.contiguous())
    t, kpb = b.shape
    vb = None if vals is None else ref.signed_bits(vals.contiguous())[0]
    if vb is not None and vb.shape != b.shape:
        raise ValueError("keys and values must have the same (T, KPB) shape")
    val_bytes = 0 if vb is None else vb.element_size()
    key_mask = ref.low_bits_mask(key_bits, b.element_size())
    val_mask = ref.low_bits_mask(val_bits, val_bytes) if val_bytes else 0
    need = smem_bytes(kpb, b.element_size(), val_bytes, width)
    if need > SMEM_LIMIT:
        raise ValueError(f"a tile of {kpb} keys needs {need} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a CTA can hold")
    dev = b.device
    out_k = torch.empty_like(b)
    out_v = None if vb is None else torch.empty_like(vb)
    digit = torch.empty((t, kpb), dtype=torch.int32, device=dev)
    rank = torch.empty_like(digit)
    hist = torch.zeros((t, 1 << width), dtype=torch.int32, device=dev)
    _build.check_cuda(b, out_k, digit, rank, hist,
                      *(() if vb is None else (vb, out_v)))
    if t and kpb:
        fn = _build.function("multisplit", "tile_multisplit_launch", _ARGS)
        with torch.cuda.device(dev):
            rc = fn(_build.ptr(b), _P(None if vb is None else vb.data_ptr()),
                    _build.ptr(out_k),
                    _P(None if out_v is None else out_v.data_ptr()),
                    _build.ptr(digit), _build.ptr(rank), _build.ptr(hist),
                    b.element_size(), val_bytes, t, kpb, shift, width,
                    int(logical), key_mask, val_mask,
                    _build.stream_handle(dev))
        _build.check("multisplit", rc)
        _build.COUNTS["multisplit" if vb is None else "multisplit_kv"] += 1
    out_k = out_k.view(keys.dtype)
    if vals is None:
        return out_k, digit, rank, hist
    return out_k, out_v.view(vals.dtype), digit, rank, hist


def tile_multisplit(keys: torch.Tensor, shift: int, width: int,
                    key_bits: int):
    """(T, KPB) keys -> (digit-major keys, digits, in-run ranks, (T, 2^width)
    histograms), all per tile.  After it, a tile's scatter is r contiguous
    run copies."""
    return _split(keys, None, shift, width, key_bits, 0)


def tile_multisplit_kv(keys: torch.Tensor, vals: torch.Tensor, shift: int,
                       width: int, key_bits: int, val_bits: int):
    """(T, KPB) keys and values -> (digit-major keys, values, digits, ranks,
    histograms): the pairs path of the scatter (paper §4.6)."""
    return _split(keys, vals, shift, width, key_bits, val_bits)
