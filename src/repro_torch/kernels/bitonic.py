"""Bitonic row sorts: port of ``repro.kernels.bitonic``.

The stable local sort launches ``csrc/local_sort.cu`` on CUDA tensors:

  * ``bitonic_sort_rows_stable`` — the reference's (S, L) table contract:
    one CTA sorts one row of (key, idx) pairs with a bitonic network in
    shared memory;
  * ``sort_segments_stable``     — the main path: one launch per size
    class sorts buckets of the key buffer in place, each by a shared-memory
    LSD radix sort over the bits its keys do not share, and moves the value
    leaves in place with them; no padded table exists in device memory.

The library's min/max network launches ``csrc/bitonic_rows.cu``:

  * ``bitonic_sort_rows``    — (S, L) keys sorted ascending;
  * ``bitonic_sort_rows_kv`` — the same network moving values by the
    reference's move mask (not stable under duplicate keys).

These take the key's own dtype: bool, (u)int8/16/32/64, (u)int4 (one per
byte), float16, bfloat16, float32, float64 and the float8 formats
e4m3fn, e5m2, e4m3fnuz, e5m2fnuz and e8m0fnu, with XLA's min/max
semantics for floats (see ``ref.bitonic_rows_ref``).  On CPU tensors
every entry runs its plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fused import MAX_LEAVES

_P = ctypes.c_void_p
_I = ctypes.c_int
_ROWS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P]
_SEG_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P]
_NET_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
#: the opt-in shared memory one CTA may use on Hopper
SMEM_LIMIT = 232448
#: ref's compare kinds -> csrc/bitonic_rows.cu's RowKind
_NET_KIND = {"u": 0, "s": 1, "f16": 2, "bf16": 3, "f32": 4, "f64": 5,
             "e4m3fn": 6, "e5m2": 7, "e4m3fnuz": 8, "e5m2fnuz": 9,
             "e8m0fnu": 10, "i4": 11, "u4": 12}


def _check_len(length: int, key_bytes: int, lane_bytes: int = 4) -> None:
    """A row of ``length`` keys plus ``lane_bytes`` per key (positions or
    values) must fit one CTA's shared memory."""
    if length & (length - 1):
        raise ValueError("row length must be a power of two")
    need = -(-length * key_bytes // 8) * 8 + lane_bytes * length
    if need > SMEM_LIMIT:
        raise ValueError(f"a row of {length} keys needs {need} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a CTA can hold")


def _network(keys: torch.Tensor, vals):
    kind = ref.row_kind(keys.dtype)
    if vals is not None and vals.shape != keys.shape:
        raise ValueError("keys and values must have the same (S, L) shape")
    if _build.on_cpu(keys):
        out = ref.bitonic_rows_ref(keys, vals)
        if _build.RECORDER is not None and keys.shape[0] and \
                keys.shape[1] > 1:
            _record_rows(keys, vals, out, True)
        return out
    s, length = keys.shape
    val_bytes = 0 if vals is None else vals.element_size()
    if length & (length - 1):
        raise ValueError("row length must be a power of two")
    smem = _build.function("bitonic_rows", "bitonic_rows_smem", [_I, _I, _I])
    smem.restype = ctypes.c_longlong
    need = smem(length, keys.element_size(), val_bytes)
    if need > SMEM_LIMIT:
        raise ValueError(f"a row of {length} keys needs {need} bytes of "
                         f"shared memory, over the {SMEM_LIMIT} a CTA can "
                         f"hold")
    keys = keys.contiguous()
    vals = None if vals is None else vals.contiguous()
    _build.check_cuda(keys, *(() if vals is None else (vals,)))
    out_k = torch.empty_like(keys)
    out_v = None if vals is None else torch.empty_like(vals)
    if s == 0 or length < 2:
        out_k.copy_(keys)
        if kind in ref.NIBBLE_KINDS:     # a 4-bit key is its low nibble
            out_k.view(torch.uint8).bitwise_and_(0xF)
        if vals is not None:
            out_v.copy_(vals)
    else:
        fn = _build.function("bitonic_rows", "bitonic_rows_launch", _NET_ARGS)
        with torch.cuda.device(keys.device):
            rc = fn(_build.ptr(keys), _P(None if vals is None else
                                         vals.data_ptr()),
                    _build.ptr(out_k), _P(None if vals is None else
                                          out_v.data_ptr()),
                    _NET_KIND[kind], keys.element_size(), val_bytes, s,
                    length, _build.stream_handle(keys.device))
        _build.check("bitonic_rows", rc)
        _build.COUNTS["bitonic_rows" if vals is None else
                      "bitonic_rows_kv"] += 1
        if _build.RECORDER is not None:
            _record_rows(keys, vals, (out_k, out_v), False)
    return out_k if vals is None else (out_k, out_v)


def _record_rows(keys, vals, out, plain) -> None:
    """Report one launch of the min/max row network to the recorder."""
    if vals is None:
        _build.RECORDER.launch("_bitonic_kernel", plain=plain, reads=(keys,),
                               writes=(out if plain else out[0],))
    else:
        _build.RECORDER.launch("_bitonic_kv_kernel", plain=plain,
                               reads=(keys, vals), writes=tuple(out))


def bitonic_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Sort each row of (S, L) keys ascending; L a power of two."""
    return _network(keys, None)


def bitonic_sort_rows_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Sort (S, L) rows by key through the same network, carrying values of
    any 1, 2, 4 or 8-byte dtype; L a power of two.  With duplicate keys a
    value moves iff its lane's key changed (the paper's non-stable pair
    semantics)."""
    return _network(keys, vals)


def bitonic_sort_rows_stable(keys: torch.Tensor, idx: torch.Tensor):
    """Sort (S, L) rows by (key, idx); L a power of two, ``idx`` int32 and
    distinct within each row.  Returns ``(sorted_keys, permuted_idx)``."""
    if _build.on_cpu(keys):
        out = ref.bitonic_sort_rows_stable_ref(keys, idx)
        if _build.RECORDER is not None and keys.shape[0] and \
                keys.shape[1] > 1:
            _build.RECORDER.launch("_bitonic_stable_kernel", plain=True,
                                   reads=(keys, idx), writes=out)
        return out
    s, length = keys.shape
    _check_len(length, keys.element_size())
    idx = idx.to(torch.int32).contiguous()
    _build.check_cuda(keys, idx)
    out_k, out_i = torch.empty_like(keys), torch.empty_like(idx)
    if s == 0 or length < 2:
        out_k.copy_(keys)
        out_i.copy_(idx)
        return out_k, out_i
    fn = _build.function("local_sort", "sort_rows_launch", _ROWS_ARGS)
    with torch.cuda.device(keys.device):
        rc = fn(_build.ptr(keys), _build.ptr(idx), _build.ptr(out_k),
                _build.ptr(out_i), keys.element_size(), s, length,
                _build.stream_handle(keys.device))
    _build.check("local_sort", rc)
    _build.COUNTS["local_sort"] += 1
    if _build.RECORDER is not None:
        _build.RECORDER.launch("_bitonic_stable_kernel", plain=False,
                               reads=(keys, idx), writes=(out_k, out_i))
    return out_k, out_i


def sort_segments_stable(buf: torch.Tensor, perm, starts: torch.Tensor,
                         sizes: torch.Tensor, length: int, leaves=(), *,
                         window_bits: int = 0, ctas: int = 0) -> None:
    """Sort the buckets ``buf[start:start+size]`` (every size <= ``length``,
    a power of two; size 0 rows are skipped) in place by (key, position),
    and move each of ``leaves`` (1-D, as long as ``buf``, 1, 2, 4 or 8-byte
    elements, at most ``MAX_LEAVES``) in place with its keys.

    ``perm`` (int32, as long as ``buf``, or None) receives each sorted
    slot's source position.  The plain version (CPU) also takes leaves of
    more dimensions, and any number of them, moved along their first.

    Two knobs of the kernel, for timing only (the CPU ignores them):
    ``window_bits`` > 0 sorts bits [0, window_bits) of every bucket in
    place of its live-bit window (the sort only where every bucket's keys
    agree above it), and ``ctas`` > 0 fixes the grid (the rows' count: one
    CTA per row).
    """
    leaves = tuple(leaves)
    if _build.on_cpu(buf):
        ref.sort_segments_ref(buf, perm, starts, sizes, length, leaves)
        if _build.RECORDER is not None and starts.shape[0]:
            _record_segments(buf, perm, leaves, True)
        return
    if length < 1 or length & (length - 1):
        raise ValueError("row length must be a power of two")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"at most {MAX_LEAVES} value leaves per launch")
    for v in leaves:
        if v.shape != buf.shape or v.element_size() not in (1, 2, 4, 8):
            raise ValueError("value leaves must be 1-D, as long as the keys, "
                             "with 1, 2, 4 or 8-byte elements")
    rows = starts.shape[0]
    if rows == 0:
        return
    starts = starts.to(torch.int32).contiguous()
    sizes = sizes.to(torch.int32).contiguous()
    _build.check_cuda(buf, starts, sizes, *leaves,
                      *(() if perm is None else (perm,)))
    nv = len(leaves)
    ptrs = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in leaves])
    widths = (ctypes.c_int * max(nv, 1))(*[v.element_size() for v in leaves])
    fn = _build.function("local_sort", "sort_segments_launch", _SEG_ARGS)
    with torch.cuda.device(buf.device):
        rc = fn(_build.ptr(buf), _P(None if perm is None else perm.data_ptr()),
                _build.ptr(starts), _build.ptr(sizes), buf.element_size(),
                rows, length, ptrs, widths, nv, window_bits, ctas,
                _build.stream_handle(buf.device))
    _build.check("local_sort", rc)
    _build.COUNTS["local_sort"] += 1
    if _build.RECORDER is not None:
        _record_segments(buf, perm, leaves, False)


def _record_segments(buf, perm, leaves, plain) -> None:
    """Report one class launch of the in-place local sort."""
    written = (buf, *leaves, *(() if perm is None else (perm,)))
    _build.RECORDER.launch("_bitonic_stable_kernel", plain=plain,
                           reads=(buf, *leaves), writes=written)
