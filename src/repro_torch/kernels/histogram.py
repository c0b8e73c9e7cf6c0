"""Digit histograms: port of ``repro.kernels.histogram.radix_histogram``
(and, in ``assigned.py``, of ``assigned_histogram``).

On a CUDA tensor the wrappers launch ``csrc/histogram.cu`` (16-byte
vector loads, per-warp shared sub-histograms with plain atomics, runs of
equal digits merged in registers: the paper's Fig. 2 fix for skew; past
9 bits one shared table per CTA; past 14 global atomics into rows, and a
total split into parts of 2^14 bins); on a CPU tensor they run the plain
version in ``ref.py``.  Keys are any integer dtype; digits use the dtype's
own shift (logical for unsigned keys).  Digit widths 1..16 on the card, as
in the reference's ``SortConfig``.

The host-side sizing is plain Python: ``aligned_split`` (the scalar head,
16-byte body and scalar tail of a range) and ``total_grid`` (the prologue's
CTA count from the SM count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
#: bytes per vector load
VECTOR_BYTES = 16
#: threads per CTA (the C side's kHistThreads)
THREADS = 256
#: CTAs per SM of the whole-array total
CTAS_PER_SM = 4
_SMS: dict = {}


def aligned_split(address: int, n: int, elem_bytes: int) -> tuple:
    """``(head, vectors, tail)`` of ``n`` elements at byte ``address``:
    ``head`` elements up to the first 16-byte boundary, then ``vectors``
    whole 16-byte vectors, then ``tail`` elements."""
    if address % elem_bytes:
        raise ValueError("address is not aligned to the element size")
    head = min(n, (-address) % VECTOR_BYTES // elem_bytes)
    per = VECTOR_BYTES // elem_bytes
    vectors = (n - head) // per
    return head, vectors, n - head - vectors * per


def total_grid(vectors: int, sms: int) -> int:
    """CTAs of the whole-array total: ``CTAS_PER_SM`` per SM, fewer when
    the vectors would not give each thread two."""
    return max(1, min(sms * CTAS_PER_SM, -(-vectors // (2 * THREADS))))


def sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


#: the widest digit of the CUDA kernels (``digit_at`` takes 16 bits)
MAX_WIDTH = 16


def check_width(width: int) -> None:
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"the CUDA kernels support digit widths "
                         f"1..{MAX_WIDTH}, got {width}")


def _launch(keys, n, chunk, grid, shift, width, out, accumulate,
            logical=False):
    """``grid`` None: the whole-array total's grid from the SM count."""
    check_width(width)
    keys, unsigned = ref.signed_bits(keys)
    logical = logical or unsigned
    _build.check_cuda(keys, out)
    head, vectors, _ = aligned_split(keys.data_ptr(), n, keys.element_size())
    if grid is None:
        grid = total_grid(vectors, sm_count(keys.device))
    fn = _build.function("histogram", "radix_histogram_launch", _ARGS)
    with torch.cuda.device(keys.device):
        rc = fn(_build.ptr(keys), n, keys.element_size(), chunk, grid, head,
                shift, width, int(logical), _build.ptr(out), accumulate,
                _build.stream_handle(keys.device))
    _build.check("histogram", rc)
    _build.COUNTS["histogram"] += 1


def radix_histogram(keys: torch.Tensor, shift: int,
                    width: int) -> torch.Tensor:
    """(T, KPB) integer keys -> (T, 2^width) int32 per-tile histograms."""
    cpu = _build.on_cpu(keys)
    if cpu:
        out = ref.radix_histogram_ref(keys, shift, width)
    else:
        t, kpb = keys.shape
        out = torch.empty((t, 1 << width), dtype=torch.int32,
                          device=keys.device)
        if t:
            _launch(keys, t * kpb, kpb, t, shift, width, out, 0)
    if _build.RECORDER is not None and keys.shape[0]:
        _build.RECORDER.launch("_hist_kernel", plain=cpu, reads=(keys,),
                               writes=(out,))
    return out


def digit_total(keys: torch.Tensor, n: int, shift: int,
                width: int) -> torch.Tensor:
    """(2^width,) int32 digit counts over ``keys[:n]`` of a 1-D carrier
    buffer (unsigned bits in a signed dtype: digits shift logically).

    The main path's prologue: the sum over tiles of ``radix_histogram``,
    computed without the (T, r) rows — a grid sized from the SM count
    strides over the keys and each CTA adds its counts into one total.
    """
    if _build.on_cpu(keys):
        return ref.radix_histogram_ref(keys[:n].reshape(1, -1), shift,
                                       width)[0]
    out = torch.zeros(1 << width, dtype=torch.int32, device=keys.device)
    if n:
        _launch(keys, n, n, None, shift, width, out, 1, logical=True)
    return out
