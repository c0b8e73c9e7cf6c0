"""Carrying data across: from numpy (or the reference's config) to the port.

The sort's "weights" are its data and its configuration.  These helpers turn
``dataclasses.asdict`` of a reference ``SortConfig`` into the port's, and
numpy keys and value pytrees into tensors on a chosen device, so both
packages sort exactly the same thing.  They also hold the small pytree
helpers the sort uses for value leaves (tuples, lists, dicts and
arrays; dict leaves in sorted key order).

Device rule of the port's entry points: work follows the device of a tensor
that is passed in; a numpy input goes to ``device`` (``"cuda"`` unless the
caller says otherwise), and with no GPU that raises — nothing moves quietly
to the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.model import SortConfig


def config_from_reference(fields: dict) -> SortConfig:
    """The port's ``SortConfig`` from ``dataclasses.asdict`` of the
    reference's (unknown keys are rejected, missing ones take defaults)."""
    names = {f.name for f in dataclasses.fields(SortConfig)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown SortConfig fields {sorted(extra)}")
    return SortConfig(**fields)


def resolve_device(device=None) -> torch.device:
    """The device a numpy input goes to: ``cuda`` by default; raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def to_tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``.

    bfloat16 arrays (ml_dtypes, as JAX makes them) cross as their 16-bit
    patterns.  A tensor stays where it is unless ``device`` is given.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    dev = resolve_device(device)
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bfloat16 comes back as its uint16
    bit pattern (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_flatten(tree):
    """(leaves, treedef) of a pytree of tuples, lists, dicts and leaves."""
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for item in tree:
            sub, d = tree_flatten(item)
            leaves += sub
            defs.append((len(sub), d))
        return leaves, (type(tree), defs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, d = tree_flatten([tree[k] for k in keys])
        return leaves, (dict, (keys, d))
    return [tree], None


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    if treedef is None:
        return leaves[0]
    kind, defs = treedef
    if kind is dict:
        keys, d = defs
        return dict(zip(keys, tree_unflatten(d, leaves)))
    out, at = [], 0
    for count, d in defs:
        out.append(tree_unflatten(d, leaves[at:at + count]))
        at += count
    return kind(out)


def tree_to_device(tree, device=None):
    """Every leaf of a pytree through :func:`to_tensor`."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [to_tensor(v, device) for v in leaves])
