"""The compositions around the kernels: port of ``repro.kernels.ops``.

  * ``local_sort_class_plan`` — power-of-two size classes (§4.2's local
                                sort configurations), unchanged;
  * ``segmented_local_sort``  — one launch per class sorts the flagged
                                buckets in place, value leaves moved in
                                place with them;
  * ``apply_run_copies``      — the value gather through the permutation
                                the local sort writes in perm mode;
  * ``kernel_local_sort``     — (S, L) padded rows through the row network;
  * ``tile_histogram_pass``   — the standalone histogram sweep.

The reference returned (src, dst) run copies over padded (rows, L) tables
and applied them to the keys and every value leaf; here the kernel sorts
keys in place and moves the value leaves in place with them, which is the
same copies without the padded tables or a gather.  ``perm`` mode writes an
O(n) permutation instead (each slot's source position, identity outside the
sorted buckets) for callers that gather themselves.

``static_nonzero`` stands in for ``jnp.nonzero(size=, fill_value=)``: a
fixed-length result with no device-to-host read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitonic import bitonic_sort_rows, sort_segments_stable
from repro_torch.kernels.histogram import radix_histogram


def static_nonzero(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """(size,) int32 positions of the first ``size`` True entries of a 1-D
    mask, padded with ``fill`` — ``jnp.nonzero(mask, size=, fill_value=)``
    without the host read ``torch.nonzero`` makes.  The (j+1)-th True sits
    where the running count first reaches j+1: one scan and a binary search
    per output slot, no scatter."""
    count = torch.cumsum(mask, 0, dtype=torch.int32)
    want = torch.arange(1, size + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(count, want)
    return torch.where(pos < mask.shape[0], pos, fill).to(torch.int32)


def apply_run_copies(perm, leaves):
    """Gather each per-key leaf through the local sort's permutation."""
    if perm is None:
        return tuple(leaves)
    return tuple(v[perm] for v in leaves)


def local_sort_class_plan(n: int, row_len: int, s_max: int,
                          min_len: int = 32):
    """Power-of-two size classes ``((L_0, rows_0), (L_1, rows_1), ...)``:
    widths double from ``min_len`` up to ``row_len``; class 0 holds up to
    ``s_max`` buckets, class i > 0 at most ``n // (L_i/2 + 1) + 1``."""
    row_len = max(1, row_len)
    l = min(row_len, max(1, min_len))
    classes = [(l, max(1, s_max))]
    while l < row_len:
        l *= 2
        cap = n // (l // 2 + 1) + 1
        classes.append((l, max(1, min(s_max, cap))))
    return tuple(classes)


def segmented_local_sort(keys: torch.Tensor, seg_start: torch.Tensor,
                         seg_size: torch.Tensor, seg_sortable: torch.Tensor,
                         row_len: int, classes=None, perm=None,
                         leaves=()) -> None:
    """Sort every flagged bucket of ``keys`` in place by (key, position),
    each of ``leaves`` (per-key arrays as long as ``keys``) moved in place
    with its keys.

    Buckets are binned by size class (``local_sort_class_plan``; ``None``
    keeps one class of width ``row_len`` with a row per segment slot) and
    each class is one launch over its (start, size) rows.  ``perm``, when
    given, receives the source position of every sorted slot.
    """
    s = seg_start.shape[0]
    if classes is None:
        classes = ((row_len, s),)
    prev_l = -1                    # class 0 catches every size <= its width
    for l, rows in classes:
        in_cls = seg_sortable & (seg_size <= l) & (seg_size > prev_l)
        rsel = static_nonzero(in_cls, min(rows, s), s)
        valid = rsel < s
        sel = torch.clamp(rsel, 0, s - 1).to(torch.int64)
        starts_c = torch.where(valid, seg_start[sel], 0)
        sizes_c = torch.where(valid, seg_size[sel], 0)
        sort_segments_stable(keys, perm, starts_c, sizes_c, l, leaves)
        prev_l = l


def kernel_local_sort(keys: torch.Tensor) -> torch.Tensor:
    """Local sort of (S, L) padded buckets through the row network."""
    return bitonic_sort_rows(keys)


def tile_histogram_pass(keys: torch.Tensor, shift: int, width: int,
                        kpb: int = 8192):
    """Histogram step of a pass: (n,) integer keys -> ((T, r) int32 tile
    histograms, (r,) int32 total).  The keys are padded to whole tiles with
    the all-ones sentinel, whose count comes off digit ``r - 1`` of the
    total, as in the reference.

    Example — the top-byte digits of two uint32 keys::

        >>> import numpy as np, torch
        >>> from repro_torch.kernels import tile_histogram_pass
        >>> x = torch.from_numpy(np.array([0x01020304, 0xFF000000], np.uint32))
        >>> hist, total = tile_histogram_pass(x, shift=24, width=8, kpb=8)
        >>> int(total[0x01]), int(total[0xFF]), int(total.sum())
        (1, 1, 2)
    """
    n = keys.shape[0]
    pad = (-n) % kpb
    b, _ = ref.signed_bits(keys)
    padded = torch.cat([b, b.new_full((pad,), -1)]).view(keys.dtype)
    hist = radix_histogram(padded.reshape(-1, kpb), shift, width)
    total = hist.sum(0, dtype=torch.int32)
    if pad:
        total[(1 << width) - 1] -= pad
    return hist, total
