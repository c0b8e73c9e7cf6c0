"""Stable local sort: port of ``repro.kernels.bitonic.bitonic_sort_rows_stable``.

Both entries launch ``csrc/local_sort.cu`` on CUDA tensors (one CTA sorts one
row of (key, position) pairs with a bitonic network in shared memory) and
run the plain versions of ``ref.py`` on CPU tensors:

  * ``bitonic_sort_rows_stable`` — the reference's (S, L) table contract;
  * ``sort_segments_stable``     — the main path: one launch per size
    class sorts buckets of the key buffer in place, without a padded table
    in device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ROWS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P]
_SEG_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
#: the opt-in shared memory one CTA may use on Hopper
SMEM_LIMIT = 232448


def _check_len(length: int, key_bytes: int) -> None:
    if length & (length - 1):
        raise ValueError("row length must be a power of two")
    need = -(-length * key_bytes // 8) * 8 + 4 * length
    if need > SMEM_LIMIT:
        raise ValueError(f"a row of {length} keys needs {need} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a CTA can hold")


def bitonic_sort_rows_stable(keys: torch.Tensor, idx: torch.Tensor):
    """Sort (S, L) rows by (key, idx); L a power of two, ``idx`` int32 and
    distinct within each row.  Returns ``(sorted_keys, permuted_idx)``."""
    if _build.on_cpu(keys):
        return ref.bitonic_sort_rows_stable_ref(keys, idx)
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
    return out_k, out_i


def sort_segments_stable(buf: torch.Tensor, perm, starts: torch.Tensor,
                         sizes: torch.Tensor, length: int) -> None:
    """Sort the buckets ``buf[start:start+size]`` (every size <= ``length``,
    a power of two; size 0 rows are skipped) in place by (key, position).

    ``perm`` (int32, same length as ``buf``, or None) receives each sorted
    slot's source position — the value gather of the finish.
    """
    if _build.on_cpu(buf):
        ref.sort_segments_ref(buf, perm, starts, sizes, length)
        return
    rows = starts.shape[0]
    if rows == 0 or length < 2:
        return
    _check_len(length, buf.element_size())
    starts = starts.to(torch.int32).contiguous()
    sizes = sizes.to(torch.int32).contiguous()
    _build.check_cuda(buf, starts, sizes, *(() if perm is None else (perm,)))
    fn = _build.function("local_sort", "sort_segments_launch", _SEG_ARGS)
    with torch.cuda.device(buf.device):
        rc = fn(_build.ptr(buf), _P(None if perm is None else perm.data_ptr()),
                _build.ptr(starts), _build.ptr(sizes), buf.element_size(),
                rows, length, buf.shape[0], _build.stream_handle(buf.device))
    _build.check("local_sort", rc)
    _build.COUNTS["local_sort"] += 1
