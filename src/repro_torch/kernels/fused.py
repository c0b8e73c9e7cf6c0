"""One fused launch per counting pass: port of ``repro.kernels.fused``.

``fused_counting_pass`` partitions every active segment by the pass digit,
copies the done gaps between them through, scatters keys and every value
leaf into the alternate ping-pong buffer, and counts the next pass's digit
histogram (and, with ``lookahead``, the one after) — one read and one write
of the keys per pass (§4.3–§4.4).  On a CUDA tensor it launches
``csrc/fused_pass.cu``: persistent CTAs take the flat descriptor rows by
ticket, rank each row stably, obtain its in-segment carries by decoupled
look-back over packed status words, and write the row out in runs from a
digit-major staging buffer.  Up to r = 512 a row publishes one word per
digit; past it (the wide variant) a row ranks in two 8-bit counting
rounds, publishes a bitmap of its live digits and one word per run, and
walks back over its live digits only (see the source note).  On a CPU
tensor it runs the plain version in ``ref.py``.
The alternate buffers are written in place and returned, which takes the
place of the reference's donation.

The scratch of both kernels is laid out and sized here, in plain Python:
``lookback_word_bytes`` (the look-back word's width from n),
``lookback_scratch_bytes`` (r <= 512) and ``wide_scratch_layout`` (r >
512); ``scratch_bytes`` picks one.  A KPB whose row does not fit one CTA's
shared memory is refused by the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.histogram import digit_total

#: value leaves one launch carries (the C side's pointer table)
MAX_LEAVES = 8
#: the widest digit histogram the CUDA pass takes: d <= 16
MAX_RADIX = 65536
#: the widest r of the look-back kernel; past it the wide variant runs
LOOKBACK_MAX_RADIX = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = ([_P, _P, _I, _P, _P, _P, _I] + [_P] * 5 + [_I, _P, _P] + [_I] * 10 +
         [_P] * 6 + [_I, _P])


def lookback_word_bytes(n: int) -> int:
    """Bytes of one look-back word: a 2-bit status over a count that can
    reach n, so 32 bits below 2^30 keys and 64 from there."""
    return 4 if n < 1 << 30 else 8


def lookback_scratch_bytes(rows: int, r: int, n: int) -> int:
    """The zeroed scratch of one launch: a 16-byte ticket slot, then one
    look-back word per (row, digit)."""
    return 16 + rows * r * lookback_word_bytes(n)


def wide_scratch_layout(rows: int, r: int, length: int, n: int) -> dict:
    """Byte offsets of the wide variant's scratch (r > 512): the int ticket
    at 0; at 16 one int flag per row; then ``bitmap``, each row's r / 32
    8-byte entries (32 live-digit bits, the popcount before them); then
    ``words``, one look-back word (``lookback_word_bytes(n)``) per slot of
    the ``length``-key buffers, since a row's runs take the words from its
    first key's offset on.  Only the first ``zeroed`` bytes (ticket and
    flags) need zeroing; ``total`` is the size."""
    bitmap = 16 + -(-4 * rows // 16) * 16
    words = bitmap + rows * (r // 32) * 8
    return dict(flags=16, bitmap=bitmap, words=words, zeroed=bitmap,
                total=words + length * lookback_word_bytes(n))


def scratch_bytes(rows: int, r: int, n: int, length: int) -> int:
    """The scratch of one CUDA launch over ``rows`` descriptor rows and
    ``length``-key buffers: the look-back words, or past r = 512 the wide
    variant's flags, bitmaps and words."""
    if r <= LOOKBACK_MAX_RADIX:
        return lookback_scratch_bytes(rows, r, n)
    return wide_scratch_layout(rows, r, length, n)["total"]


def pad_length(n: int, kpb: int) -> int:
    """Padded ping-pong length: whole KPB tiles plus one spare tile (slot
    ``n`` is the trash slot)."""
    return n + ((-n) % kpb) + kpb


def make_ping_pong(keys: torch.Tensor, val_leaves, kpb: int):
    """Pad keys (all-ones sentinel, the carrier's -1) and value leaves
    (zeros) into ``(cur_keys, cur_vals), (alt_keys, alt_vals)``."""
    n = keys.shape[0]
    pad = pad_length(n, kpb) - n
    ck = torch.cat([keys, keys.new_full((pad,), -1)])
    cv = tuple(torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
               for v in val_leaves)
    ak = torch.full_like(ck, -1)
    av = tuple(torch.zeros_like(v) for v in cv)
    return (ck, cv), (ak, av)


def initial_histogram(buf_keys: torch.Tensor, n: int, lo: int, width: int,
                      r: int, a_max: int, kpb: int) -> torch.Tensor:
    """Pass 0's (a_max, r) histogram table over the single segment [0, n):
    the one unfused key sweep of the sort (§4.3), row 0 populated."""
    r0 = 1 << width
    cpu = _build.on_cpu(buf_keys)
    if cpu:
        # the reference's form: tile rows, sum, drop the sentinel padding
        hist = ref.radix_histogram_ref(buf_keys.reshape(-1, kpb), lo,
                                       width).sum(0, dtype=torch.int32)
        hist[r0 - 1] -= buf_keys.shape[0] - n
    else:
        hist = digit_total(buf_keys, n, lo, width)
    if _build.RECORDER is not None and n:
        _build.RECORDER.launch("_hist_kernel", plain=cpu, reads=(buf_keys,),
                               writes=(hist,))
    out = torch.zeros((a_max, r), dtype=torch.int32, device=buf_keys.device)
    out[0, :r0] = hist
    return out


def _launch(src_keys, src_vals, alt_keys, alt_vals, sc, tables, base_excl,
            next_sid, kpb, r, a_max, n, lookahead):
    if r > MAX_RADIX:
        raise ValueError(f"the CUDA fused pass supports d <= 16 (r <= "
                         f"{MAX_RADIX}), got r = {r}")
    if len(src_vals) > MAX_LEAVES:
        raise ValueError(f"at most {MAX_LEAVES} value leaves per launch")
    for v in src_vals:
        if v.dim() != 1 or v.element_size() not in (1, 2, 4, 8):
            raise ValueError("value leaves must be 1-D with 1, 2, 4 or "
                             "8-byte elements")
    dev = src_keys.device
    tables = [t.reshape(-1).to(torch.int32).contiguous() for t in tables]
    base_excl = base_excl.to(torch.int32).contiguous()
    next_sid = next_sid.to(torch.int32).contiguous()
    _build.check_cuda(src_keys, alt_keys, *src_vals, *alt_vals, *tables,
                      base_excl, next_sid)
    rows = tables[0].shape[0]
    hist = torch.zeros(a_max * r, dtype=torch.int32, device=dev)
    hist2 = torch.zeros_like(hist) if lookahead else None
    if r <= LOOKBACK_MAX_RADIX:
        scratch = torch.zeros(lookback_scratch_bytes(rows, r, n),
                              dtype=torch.uint8, device=dev)
        at = dict(words=16)
    else:
        at = wide_scratch_layout(rows, r, src_keys.shape[0], n)
        scratch = torch.empty(at["total"], dtype=torch.uint8, device=dev)
        scratch[:at["zeroed"]].zero_()
    base = scratch.data_ptr()
    spans = [_P(base + at[k]) if k in at else _P(None)
             for k in ("words", "flags", "bitmap")]
    nv = len(src_vals)
    val_src = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in src_vals])
    val_dst = (ctypes.c_void_p * max(nv, 1))(*[v.data_ptr() for v in alt_vals])
    val_bytes = (ctypes.c_int * max(nv, 1))(*[v.element_size()
                                              for v in src_vals])
    lo, width, nlo, nwidth, n2lo, n2width = sc
    fn = _build.function("fused_pass", "fused_pass_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(src_keys), _build.ptr(alt_keys),
                src_keys.element_size(), val_src, val_dst, val_bytes, nv,
                *[_build.ptr(t) for t in tables], rows, _build.ptr(base_excl),
                _build.ptr(next_sid), lo, width, nlo, nwidth, n2lo, n2width,
                int(lookahead), r, a_max, kpb, _build.ptr(hist),
                _P(hist2.data_ptr() if lookahead else None),
                _build.ptr(scratch), *spans, lookback_word_bytes(n),
                _build.stream_handle(dev))
    _build.check("fused_pass", rc)
    _build.COUNTS["fused_pass"] += 1
    return (hist, hist2) if lookahead else (hist,)


def fused_counting_pass(src_keys, src_vals, alt_keys, alt_vals, pass_scalars,
                        blk_seg, blk_off, blk_reset, blk_count, blk_active,
                        base_excl, next_sid, *, kpb: int, r: int, a_max: int,
                        n: int, lookahead: bool = False):
    """One full counting pass over all active buckets in one launch.

    Arguments follow the reference: current buffers ``src_keys`` /
    ``src_vals`` (a tuple of 1-D leaves), alternate buffers ``alt_keys`` /
    ``alt_vals`` (written in place), ``pass_scalars`` = the digit windows
    ``(lo, width, next_lo, next_width[, next2_lo, next2_width])`` as ints
    (``plan.digit_window``), the descriptor tables of
    ``plan.make_region_blocks`` (flat (G,) or packed (G', B): rows are read
    in descriptor order either way), ``base_excl`` (a_max, r) absolute run
    starts and ``next_sid`` (a_max * r,) next-pass segment ids.

    Returns ``(new_keys, new_vals, hist_next)`` and, with ``lookahead``,
    ``hist_next2`` as a fourth element; the histograms are (a_max * r,).
    Rows of count 0 are no-ops (the kernel is quickest when they trail the
    table, as the planner's pads do); a copy-through or count-0 row must not
    sit between a region's first row and its later rows.
    """
    sc = [int(v) for v in pass_scalars]
    sc = (sc + [0, 0])[:6]
    tables = (blk_seg, blk_off, blk_reset, blk_count, blk_active)
    cpu = _build.on_cpu(src_keys)
    if cpu:
        out = ref.fused_counting_pass_ref(
            src_keys, src_vals, alt_keys, alt_vals, sc, *tables, base_excl,
            next_sid, kpb=kpb, r=r, a_max=a_max, n=n, lookahead=lookahead)
    else:
        out = (alt_keys, tuple(alt_vals),
               *_launch(src_keys, tuple(src_vals), alt_keys, tuple(alt_vals),
                        sc, tables, base_excl, next_sid, kpb, r, a_max, n,
                        lookahead))
    if _build.RECORDER is not None:
        _build.RECORDER.launch(
            "_fused_pass_kernel", plain=cpu, reads=(src_keys, *src_vals),
            writes=(out[0], *out[1]), alts=(alt_keys, *alt_vals),
            tables=blk_seg.shape,
            call=(fused_counting_pass,
                  (src_keys, src_vals, alt_keys, alt_vals, sc, *tables,
                   base_excl, next_sid),
                  dict(kpb=kpb, r=r, a_max=a_max, n=n, lookahead=lookahead)))
    return out
