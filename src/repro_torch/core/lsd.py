"""LSD radix sort baseline — the CUB/Merrill analogue (paper §3): port of
``repro.core.lsd``.

State-of-the-art GPU radix sorts are least-significant-digit-first with
d = 4 or 5 bits per *stable* pass (CUB 1.5.1: d = 5; the CUB 1.6.4
appendix: up to d = 7).  This is the baseline the hybrid sort is compared
against: ⌈k/d⌉ stable counting passes, each reading and writing every key.

``lsd_sort`` resolves its engine as ``hybrid_sort`` does (``auto`` is
``kernel`` on CUDA, ``argsort`` on the CPU):

  * ``kernel`` — the degenerate plan of the hybrid sort: one always-active
    segment over [0, n) (base 0, size n, every sub-bucket to segment 0,
    a_max 1), one prologue histogram (``kernels.histogram``) and then one
    fused launch per pass (``kernels.fused``) on ping-pong buffers, each
    pass's digit histogram counted during the previous pass's scatter
    (§4.3).  On CUDA these are the hand-written kernels, and a kernel that
    fails to build or launch raises; on a CPU tensor, their plain versions;
  * ``argsort`` / ``scan`` — each pass's destinations from
    ``ranks.stable_partition_dest``.

The launches are statically unrolled: no device-to-host read besides the
live-bit window of ``adaptive`` (counted in
``kernels._build.COUNTS["host_reads"]``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import bijection, interop, model, plan
from repro_torch.core.hybrid import _MOVABLE, live_bit_window
from repro_torch.core.ranks import resolve_engine, stable_partition_dest

_I32 = torch.int32


def _lsd_sort_torch(ukeys, leaves, d: int, k: int, engine: str, lo: int,
                    nd: int):
    """The plain-torch engines: pass p moves every key and leaf to its
    stable slot by the digit at bits [lo + p·d, min(lo + (p+1)·d, k))."""
    for p in range(nd):
        shift = lo + p * d
        width = min(d, k - shift)
        # widen before masking: an 8-bit mask does not fit an int8 carrier
        digit = (ukeys >> shift).to(_I32) & ((1 << width) - 1)
        dest = stable_partition_dest(digit, 1 << d, engine=engine)
        new_keys = torch.empty_like(ukeys)
        new_keys[dest] = ukeys
        new_leaves = []
        for v in leaves:
            nv = torch.empty_like(v)
            nv[dest] = v
            new_leaves.append(nv)
        ukeys, leaves = new_keys, new_leaves
    return ukeys, leaves


def lsd_sort(keys, values: Any = None, d: int = 5,
             engine: Optional[str] = None, kpb: int = 1024,
             adaptive: bool = True, return_passes: bool = False,
             device=None):
    """Stable LSD radix sort with ``d``-bit digits (default 5, the CUB
    proxy).

    ``keys`` (1-D, any dtype ``bijection`` takes) and ``values`` (an
    optional array or pytree of arrays permuted alongside) may be tensors
    or numpy arrays; work runs on the keys' device, and numpy inputs go to
    ``device`` — the GPU unless the caller asks for ``"cpu"``.  ``engine``
    is ``"kernel"``, ``"argsort"``, ``"scan"`` or ``None`` / ``"auto"``
    (``kernel`` on CUDA, ``argsort`` on the CPU); ``kpb`` is the kernel
    engine's keys per block.

    ``adaptive`` narrows the schedule to the live bit window of the keys
    (⌈k_eff/d⌉ passes; the bits outside it are the same in every key, so
    the elided passes were identity permutations).  ``return_passes``
    appends the executed pass count.  Returns ``sorted_keys`` or
    ``(sorted_keys, permuted_values)``, as the reference does.
    """
    keys = interop.to_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError("lsd_sort expects a 1-D key array")
    if values is not None:
        values = interop.tree_to_device(values, keys.device)
    engine = resolve_engine(engine, keys.device)
    k = bijection.key_bits(keys.dtype)
    if keys.shape[0] == 0:
        out = keys if values is None else (keys, values)
        if return_passes:
            return (*((out,) if values is None else out), 0)
        return out
    carrier = bijection.to_ordered_bits(keys)
    lo, hi = live_bit_window(carrier) if adaptive else (0, k)
    nd = model.num_digits(max(hi - lo, 0), d)
    leaves, treedef = interop.tree_flatten(values if values is not None
                                           else ())
    dtypes = [v.dtype for v in leaves]
    # torch cannot scatter or gather uint16/32/64: move their signed twins
    leaves = [v.view(_MOVABLE.get(v.dtype, v.dtype)) for v in leaves]
    if engine == "kernel":
        ukeys, leaves, _ = plan.one_segment_passes(carrier, leaves, d, hi,
                                                   kpb, lo, nd)
    else:
        ukeys, leaves = _lsd_sort_torch(carrier, leaves, d, hi, engine, lo,
                                        nd)
    out = bijection.from_ordered_bits(ukeys, keys.dtype)
    if values is not None:
        leaves = [v.view(dt) for v, dt in zip(leaves, dtypes)]
        out = (out, interop.tree_unflatten(treedef, leaves))
    if return_passes:
        return (*((out,) if values is None else out), nd)
    return out
