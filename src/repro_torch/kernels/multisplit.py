"""Tile multisplit: port of ``repro.kernels.multisplit.tile_multisplit`` and
``tile_multisplit_kv`` (paper §4.4's shared-memory write combining, §4.6's
pairs).

Per (KPB,) tile: the keys (and values) stably reordered digit-major, each
output slot's digit and rank in its digit run, and the tile's histogram.
On a CUDA tensor the wrappers launch ``csrc/multisplit.cu`` (one CTA per
tile: the tile loaded once into shared memory with 16-byte loads, ranked
stably through per-warp digit bitmasks, and written out in slot order
with 16-byte stores); on a CPU tensor they run the plain version in
``ref.py``.

Keys and values take their own dtype: uint16, int32, uint32, int64 or
uint64, the dtypes the reference's 16-bit-half round trip accepts.  As
there, only the low ``16 * ceil(key_bits / 16)`` key bits (``val_bits``
for values) come back, and digits use the key dtype's own shift.  Digit
widths 1..16 on the card (past 8 the rank takes two 8-bit rounds).  A
tile whose shared memory (``csrc/multisplit.cu``'s layout) is over the
card's limit is refused by the launch.
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
_PROBE_ARGS = _ARGS[:-1] + [_I, _P]
#: the phases ``_multisplit_probe`` can run besides the load
#: (csrc/multisplit.cu: kRankPhase, kWritePhase)
_PHASES = {"load": 0, "rank": 1, "write": 2, "full": 3}


def _split(keys, vals, shift, width, key_bits, val_bits, phases=None):
    if _build.on_cpu(keys):
        out = ref.tile_multisplit_kv_ref(keys, vals, shift, width, key_bits,
                                         val_bits)
        if _build.RECORDER is not None and keys.numel():
            _record(keys, vals, out, True)
        return out
    check_width(width)
    ref.check_multisplit_dtypes(keys, vals)
    b, logical = ref.signed_bits(keys.contiguous())
    t, kpb = b.shape
    vb = None if vals is None else ref.signed_bits(vals.contiguous())[0]
    if vb is not None and vb.shape != b.shape:
        raise ValueError("keys and values must have the same (T, KPB) shape")
    val_bytes = 0 if vb is None else vb.element_size()
    key_mask = ref.low_bits_mask(key_bits, b.element_size())
    val_mask = ref.low_bits_mask(val_bits, val_bytes) if val_bytes else 0
    dev = b.device
    out_k = torch.empty_like(b)
    out_v = None if vb is None else torch.empty_like(vb)
    digit = torch.empty((t, kpb), dtype=torch.int32, device=dev)
    rank = torch.empty_like(digit)
    hist = torch.zeros((t, 1 << width), dtype=torch.int32, device=dev)
    _build.check_cuda(b, out_k, digit, rank, hist,
                      *(() if vb is None else (vb, out_v)))
    if t and kpb:
        with torch.cuda.device(dev):
            args = [_build.ptr(b), _P(None if vb is None else vb.data_ptr()),
                    _build.ptr(out_k),
                    _P(None if out_v is None else out_v.data_ptr()),
                    _build.ptr(digit), _build.ptr(rank), _build.ptr(hist),
                    b.element_size(), val_bytes, t, kpb, shift, width,
                    int(logical), key_mask, val_mask]
            if phases is None:
                fn = _build.function("multisplit", "tile_multisplit_launch",
                                     _ARGS)
            else:
                fn = _build.function("multisplit", "tile_multisplit_probe",
                                     _PROBE_ARGS)
                args.append(_PHASES[phases])
            rc = fn(*args, _build.stream_handle(dev))
        _build.check("multisplit", rc, refused=(
            f"a tile of {kpb} keys is over 65536 keys or over the shared "
            f"memory one CTA can hold"))
        _build.COUNTS["multisplit" if vb is None else "multisplit_kv"] += 1
        if _build.RECORDER is not None and phases is None:
            _record(keys, vals, (out_k, *(() if out_v is None else (out_v,)),
                                 digit, rank, hist), False)
    out_k = out_k.view(keys.dtype)
    if vals is None:
        return out_k, digit, rank, hist
    return out_k, out_v.view(vals.dtype), digit, rank, hist


def _record(keys, vals, out, plain) -> None:
    """Report one multisplit launch to the recorder."""
    _build.RECORDER.launch(
        "_multisplit_kernel" if vals is None else "_multisplit_kv_kernel",
        plain=plain, reads=(keys,) if vals is None else (keys, vals),
        writes=tuple(out))


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


def _multisplit_probe(keys: torch.Tensor, vals, shift: int, width: int,
                      key_bits: int, val_bits: int, phases: str):
    """One launch of the multisplit on CUDA tensors running only some of
    its phases besides the tile load: ``"load"`` (nothing else), ``"rank"``
    (the stable order, nothing written), ``"write"`` (the writes of an
    identity order) or ``"full"``.  For timing only
    (``scripts/torch_multisplit_breakdown.py``): a partial launch's outputs
    are not the multisplit's."""
    return _split(keys, vals, shift, width, key_bits, val_bits, phases)
