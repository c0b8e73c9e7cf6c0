"""Name-based sharding rules: DP over (pod, data), TP/EP over model, FSDP
storage sharding over data for the large architectures (port of
``repro.launch.sharding``).

Rules are *divisibility-guarded*: a dimension is sharded only when it divides
the axis size (e.g. musicgen's 24 heads don't divide the 16-way model axis ->
attention weights replicate, the FFN still shards).  Everything is expressed
over axis NAMES, so the same rules re-apply on any mesh — the elasticity
contract.

Specs are the port's own :class:`P`, a tuple that compares as the
reference's ``PartitionSpec`` does; :func:`to_placements` turns one into
DTensor placements on a ``DeviceMesh``.  The port's parameters are
per-layer dicts (``params["layers"][i]``), not the reference's stacked
``(L, ...)`` leaves: :func:`param_spec` takes the port's path and shape and
returns the reference's spec for the stacked leaf without its leading
``None`` (the L dim, which is never sharded).
"""
from __future__ import annotations

from typing import Any

from torch.distributed.tensor import (Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import axis_sizes, data_axes


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of names (major first).  Trailing dims not
    named are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _norm_axis(axis):
    """Collapse single-element axis tuples to the bare name.

    ``data_axes(mesh)`` returns a tuple so pod composes with data, but a
    one-axis mesh partition must read ``P(None, 'data', None)`` — the
    canonical spec every consumer (and spec equality) expects — not
    ``P(None, ('data',), None)``.  Multi-axis tuples pass through.
    """
    if isinstance(axis, tuple):
        if len(axis) == 1:
            return axis[0]
        return axis if axis else None
    return axis


def _div(n: int, mesh, axis) -> bool:
    sizes = axis_sizes(mesh)
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[a]
    return n % size == 0 and n > 0


def param_spec(path: str, shape, cfg, mesh) -> P:
    """Spec for one parameter (or optimizer-state) leaf of the port's tree.

    ``path`` is the leaf's key string (``"['layers'][3]['attn']['wq']"``);
    a per-layer leaf gets the reference's stacked spec without the leading
    ``None``."""
    dp = data_axes(mesh)
    dims = list(shape)

    def out(*spec):
        spec = [_norm_axis(s) for s in spec] + [None] * (len(dims) - len(spec))
        return P(*spec)

    fsdp = cfg.fsdp_params

    if "embed" in path or "lm_head" in path:
        v_dim = 0 if "embed" in path else 1
        if len(dims) < 2:                  # factored optimizer state (vr/vc)
            return out()
        if _div(dims[v_dim], mesh, "model"):
            return out(*(("model", None) if v_dim == 0 else (None, "model")))
        return out()

    if "router" in path:
        return out()
    if "w_gate" in path or "w_up" in path or "w_down" in path:
        if len(dims) == 3:                        # MoE experts (E, d, f)/(E, f, d)
            spec = ["model" if _div(dims[0], mesh, "model") else None, None, None]
            if fsdp and _div(dims[1], mesh, dp):
                spec[1] = dp
            return out(*spec)
        if len(dims) != 2:                        # factored state
            return out()
        # dense FFN (d, f) / (f, d)
        f_dim = 1 if "down" not in path else 0
        spec = [None, None]
        if _div(dims[f_dim], mesh, "model"):
            spec[f_dim] = "model"
        if fsdp and _div(dims[1 - f_dim], mesh, dp):
            spec[1 - f_dim] = dp
        return out(*spec)

    if len(dims) < 2:                             # vectors / factored states
        return out()
    if any(k in path for k in ("wq", "wk", "wv")):
        heads = cfg.n_heads_padded if "wq" in path else cfg.n_kv_padded
        if heads and _div(heads, mesh, "model"):
            return out(None, "model")
        if fsdp and _div(dims[0], mesh, dp):
            return out(dp, None)
        return out()
    if "wo" in path:
        if cfg.n_heads and _div(cfg.n_heads_padded, mesh, "model"):
            return out("model", None)
        if fsdp and _div(dims[1], mesh, dp):
            return out(None, dp)
        return out()

    if "in_proj" in path:                          # ssm (d, 2di+2n+h)
        return out(None, "model") if _div(dims[1], mesh, "model") else out()
    if "out_proj" in path:                         # ssm (di, d)
        return out("model", None) if _div(dims[0], mesh, "model") else out()

    return out()                                   # norms, scalars, conv, A/D


def leaves_with_paths(tree, prefix: str = ""):
    """[(key string, leaf)] of a tree of dicts (sorted keys, as
    ``jax.tree_util`` orders them), lists, tuples and NamedTuples; None
    subtrees hold no leaf, and a spec :class:`P` is a leaf.  Key strings
    read as ``jax.tree_util.keystr``
    does: ``['layers'][0]['attn']['wq']``, a NamedTuple field ``.kv_k``."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for k in tree._fields
                for kv in leaves_with_paths(getattr(tree, k),
                                            f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_tree(fn, tree, prefix: str = ""):
    """``fn(key string, leaf)`` over the leaves of ``tree`` (the walk of
    :func:`leaves_with_paths`: a spec :class:`P` is a leaf), keeping its
    structure."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, getattr(tree, k), f"{prefix}.{k}")
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _spec_like(tree, cfg, mesh):
    """Specs for a params (or optimizer-state) tree of tensors (meta
    tensors will do: only shapes are read), each checked against its
    leaf's rank and divisibility, replicated where it does not fit."""
    def spec_of(path, leaf):
        shp = tuple(leaf.shape)
        spec = param_spec(path, shp, cfg, mesh)
        if len(spec) > len(shp):                   # scalar/odd-rank state leaf
            spec = P()
        # rank/divisibility sanity: fall back to replication when mismatched
        for dim, ax in zip(shp, tuple(spec) + (None,) * len(shp)):
            if ax is not None and not _div(dim, mesh, ax):
                return P()
        return spec
    return map_tree(spec_of, tree)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(i)`` on
    each mesh dim that tensor dim i names, ``Replicate()`` on the others.
    A tuple ``("pod", "data")`` shards one tensor dim over two mesh dims,
    major first (the mesh's own order), as JAX does.  A mesh dim of size 1
    replicates (DTensor refuses to reshape a dim "sharded" one way)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of {spec} are not in the mesh's "
                             f"major-to-minor order {tuple(names)}")
        for j in idx:
            if mesh.size(j) > 1:          # one shard of one rank: replicated
                out[j] = Shard(i)
    return tuple(out)


def param_shardings(params, cfg, mesh):
    """Placements for a params (or optimizer-state) tree."""
    return to_shardings(_spec_like(params, cfg, mesh), mesh)


def batch_specs(cfg, mesh, shape_cfg) -> Any:
    dp = data_axes(mesh)
    b = shape_cfg.global_batch
    dpn = _norm_axis(dp)
    tok = P(dpn, None) if _div(b, mesh, dp) else P()
    out = {"tokens": tok}
    if cfg.frontend == "vision_patches":
        out["patches"] = P(dpn, None, None) if _div(b, mesh, dp) else P()
    return out


def cache_specs(cfg, mesh, batch: int, max_len: int):
    """DecodeCache specs: batch over DP when divisible, else sequence; KV heads
    over model when divisible, else sequence over model too (flash-decode
    style partial-KV layout).  The port's cache holds one tensor per layer,
    so each spec is the reference's without the leading L entry, and
    ``length`` is a Python int (spec ``None``)."""
    dp = data_axes(mesh)
    b_ok = _div(batch, mesh, dp)
    kv_ok = cfg.n_kv_heads and _div(cfg.n_kv_padded, mesh, "model")
    kv_k = kv_v = ssm_state = ssm_conv = None
    if cfg.has_attention:
        bspec = _norm_axis(dp) if b_ok else None
        hspec = "model" if kv_ok else None
        # sequence picks up every axis not used by batch/heads (flash-decode
        # partial-KV layout: each model shard holds a slice of history)
        seq_axes = tuple(a for ok, axes in ((b_ok, dp), (kv_ok, ("model",)))
                         if not ok for a in axes)
        sspec = (_norm_axis(seq_axes)
                 if seq_axes and _div(max_len, mesh, seq_axes) else None)
        kv_k = kv_v = P(bspec, sspec, hspec, None)
    if cfg.has_ssm:
        h_ok = _div(cfg.ssm_heads, mesh, "model")
        bs = _norm_axis(dp) if b_ok else None
        ssm_state = P(bs, "model" if h_ok else None, None, None)
        ssm_conv = P(bs, None, None)
    from repro_torch.models import DecodeCache
    return DecodeCache(kv_k, kv_v, ssm_state, ssm_conv, None)


def to_shardings(spec_tree, mesh):
    """Placements for every spec of a tree (dicts, lists, NamedTuples; a
    ``None`` entry stays ``None``)."""
    return map_tree(lambda _, spec: to_placements(spec, mesh), spec_tree)


def distribute(tree, placements, mesh):
    """Each tensor of ``tree`` as a DTensor with the matching placements
    (``placements`` from :func:`param_shardings` / :func:`to_shardings`;
    a per-layer cache spec applies to every layer's tensor).  The tensors
    are the global values: each rank keeps its shard."""
    def go(t, pl):
        if t is None or pl is None:             # absent, or a Python int
            return t
        if isinstance(pl, tuple) and all(isinstance(p, Placement)
                                         for p in pl):
            if isinstance(t, (list, tuple)):    # one cache tensor a layer
                return type(t)(distribute_tensor(a, mesh, pl) for a in t)
            return distribute_tensor(t, mesh, pl)
        if isinstance(t, dict):
            return {k: go(v, pl[k]) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(a, b) for a, b in zip(t, pl)))
        return type(t)(go(a, b) for a, b in zip(t, pl))
    return go(tree, placements)
