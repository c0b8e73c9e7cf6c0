"""Mixture-of-Experts layer with *sort-based* token dispatch: port of
``repro.models.moe``.

The integration point of the paper: routing top-k tokens to E experts is a
single hybrid-radix counting pass on the expert id (E <= 2^d: qwen3's 128
experts are one d=7 digit, kimi-k2's 384 one d=9 digit).  The dispatch is
``repro_torch.core.segmented.capacity_dispatch`` — histogram, prefix-sum,
scatter (§4.1 steps 1–3) with the capacity row playing the paper's reserved
memory chunk (§4.4) — over ``core.plan.single_pass_partition``: on the GPU
one prologue histogram and one fused counting pass (the hand-written
kernels of ``csrc/histogram.cu`` and ``csrc/fused_pass.cu``), on the CPU
the argsort engine (``engine=None``), or the kernels' plain versions with
``engine="kernel"``.

Dispatch is *grouped*: tokens are viewed as (G, T/G), and each group is
dispatched by its own ``capacity_dispatch`` call (two launches a group).
The combine reads each token's k expert outputs back through the dispatch's
``position`` / ``kept`` and sums them over k: a gather, not a scatter-add,
so it has no float atomics and gives the same bits on every run whose
dispatch tables are the same.  The gradient keeps that property: the
dispatch gather and the combine gather are each a ``torch.autograd.Function``
whose backward is the mirror gather through the same tables (autograd's
own backward of a gather is an accumulating scatter, float atomics on
CUDA).  The tables are integers and carry no gradient.

On a mesh (``launch.mesh.use_mesh``, DTensor parameters and activations)
the layer constrains the routing tables to whole tokens on each data
shard, at the reference's points (``layers.constrain``).  The dispatch
tables are built under ``local_map``: each data shard's groups are
partitioned by its own ``capacity_dispatch`` calls on its local tensors
(on the card the histogram and fused-pass kernels), so a group's counting
pass stays local to its shard, as the reference's does.  The reference's
constraints inside the dispatch (groups on their data shards, experts on
the model axis) become the placements of a second ``local_map``, an
expert-parallel block (:func:`_experts_on_mesh`).  Off a mesh nothing
changes.

A GShard-style dense one-hot dispatch is kept as the baseline
(``moe_dispatch="dense"``): same result, more memory traffic.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.segmented import capacity_dispatch
from repro_torch.launch.mesh import model_shards
from repro_torch.launch.sharding import P, _div, to_placements
from repro_torch.models.layers import (_ContiguousGrad, abstract_mesh,
                                       constrain, dense_init, dp_axes, normal)

_F32 = torch.float32


def init_moe(generator, cfg, dtype, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(generator, d, e, _F32, device=device),  # fp32
        "w_gate": normal(generator, (e, d, f), dtype, device),
        "w_up": normal(generator, (e, d, f), dtype, device),
        "w_down": normal(generator, (e, f, d), dtype, device),
    }


def _route(x_flat, router, top_k: int):
    """(weights (T, k), ids (T, k) int32, aux): the top-k experts of each
    token in ``jax.lax.top_k``'s order — descending probability, the lower
    expert id first among equal ones (a stable descending sort;
    ``torch.topk`` does not promise that order)."""
    logits = x_flat.to(_F32) @ router                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    probs = constrain(probs, P(dp_axes(), None))            # token-sharded top_k
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = srt.values[:, :top_k], srt.indices[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary (Switch-style)
    t, e = probs.shape
    # counted by comparison (``torch.bincount`` reads its maximum back; a
    # scatter into a fresh tensor cannot take a sharded DTensor's ids)
    top1 = (ids[:, :1] == torch.arange(e, device=probs.device)).sum(
        0, dtype=torch.int32)
    frac_tokens = top1.to(_F32) / t
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return weights, ids.to(torch.int32), aux


def _expert_ffn(buf, params):
    """buf: (..., E, C, d) expert-major tokens -> (..., E, C, d)."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, params["w_gate"]))
    h = h * torch.einsum("...ecd,edf->...ecf", buf, params["w_up"])
    return torch.einsum("...ecf,efd->...ecd", h, params["w_down"])


def _dispatch_tables(flat_ids, e: int, capacity: int,
                     engine: Optional[str] = None):
    """One ``capacity_dispatch`` per group of (G, m) expert ids: the
    reference's ``vmap`` over groups, two kernel launches a group.
    Returns (gather_idx (G,E,C), slot_valid, position (G,m), kept)."""
    cds = [capacity_dispatch(row, e, capacity, engine=engine)
           for row in flat_ids]
    return tuple(torch.stack(f) for f in zip(*[
        (cd.gather_idx, cd.slot_valid, cd.position, cd.kept) for cd in cds]))


def _tables_on_mesh(flat_ids, e: int, capacity: int,
                    engine: Optional[str] = None):
    """:func:`_dispatch_tables` of (G, m) ids; on a mesh under
    ``local_map``, each rank partitioning the groups of its data shard
    (every group, replicated, when G does not divide over the data
    axes)."""
    mesh = abstract_mesh()
    if mesh is None or not isinstance(flat_ids, DTensor):
        return _dispatch_tables(flat_ids, e, capacity, engine)
    dp = dp_axes()
    split = bool(dp) and _div(flat_ids.shape[0], mesh, dp)
    rows = to_placements(P(dp, None) if split else P(), mesh)
    cube = to_placements(P(dp, None, None) if split else P(), mesh)
    fn = local_map(lambda ids: _dispatch_tables(ids, e, capacity, engine),
                   out_placements=(cube, cube, rows, rows),
                   in_placements=(rows,), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(flat_ids)


def _gather_rows(src, idx, valid):
    """out[g, i] = src[g, idx[g, i]] where ``valid``, else 0: src (G, N, d),
    idx / valid (G, M) -> (G, M, d)."""
    g, mm = idx.shape
    out = torch.gather(src, 1, idx[..., None].expand(g, mm, src.shape[-1]))
    return out.masked_fill(~valid[..., None], 0)


class _Dispatch(torch.autograd.Function):
    """The expert-major buffer: buf[g, e, c] = x[g, gather_idx[g, e, c] // k]
    for valid slots, 0 elsewhere.  Backward: each token sums the gradient
    of its k slots, read back through ``slot`` / ``kept`` (a gather)."""

    @staticmethod
    def forward(ctx, xg, gather_idx, slot_valid, slot, kept, k):
        ctx.save_for_backward(slot, kept)
        ctx.k = k
        g, e, c = gather_idx.shape
        token_of = (gather_idx // k).reshape(g, e * c)
        return _gather_rows(xg, token_of, slot_valid.reshape(g, e * c)) \
            .reshape(g, e, c, xg.shape[-1])

    @staticmethod
    def backward(ctx, dbuf):
        slot, kept = ctx.saved_tensors
        g, e, c, d = dbuf.shape
        picked = _gather_rows(dbuf.reshape(g, e * c, d), slot, kept)
        dx = picked.reshape(g, -1, ctx.k, d).sum(dim=2)
        return dx, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """Each routed assignment's expert output: picked[g, i] =
    out[g, slot[g, i]] where ``kept``, else 0.  Backward: each valid slot
    reads the gradient of the assignment ``gather_idx`` names (a gather)."""

    @staticmethod
    def forward(ctx, out, slot, kept, gather_idx, slot_valid):
        ctx.save_for_backward(gather_idx, slot_valid)
        g, e, c, d = out.shape
        return _gather_rows(out.reshape(g, e * c, d), slot, kept)

    @staticmethod
    def backward(ctx, dpicked):
        gather_idx, slot_valid = ctx.saved_tensors
        g, e, c = gather_idx.shape
        dout = _gather_rows(dpicked, gather_idx.reshape(g, e * c),
                            slot_valid.reshape(g, e * c))
        return dout.reshape(g, e, c, -1), None, None, None, None


def _sort_dispatch(xg, ids, wts, params, e: int, capacity: int,
                   engine: Optional[str] = None):
    """Sort-based dispatch/combine over (G, Tg, ·) grouped tokens."""
    g, tg, k = ids.shape
    m = tg * k
    flat_ids = ids.reshape(g, m)
    gather_idx, slot_valid, position, kept = _tables_on_mesh(
        flat_ids, e, capacity, engine)
    src = torch.clamp(gather_idx, max=m - 1).long()              # (G,E,C)
    slot = torch.where(kept, flat_ids.long() * capacity + position.long(), 0)
    return _experts_on_mesh(xg, src, slot_valid, slot, kept, wts, params, k)


def _experts(xg, src, slot_valid, slot, kept, wts, w_gate, w_up, w_down,
             k: int, first: int = 0):
    """Dispatch, expert FFN and combine for the experts ``first ..`` that
    ``w_gate`` holds (all of them off a mesh): (G, Tg, d), each token the
    weighted sum of its kept slots among those experts."""
    g, tg = xg.shape[:2]
    m = tg * k
    el, c = w_gate.shape[0], src.shape[2]
    if el != src.shape[1]:              # one model shard's experts
        lo = first * c
        src = src[:, first:first + el]
        slot_valid = slot_valid[:, first:first + el]
        kept = kept & (slot >= lo) & (slot < lo + el * c)
        slot = torch.where(kept, slot - lo, 0)
    buf = _Dispatch.apply(xg, src, slot_valid, slot, kept, k)    # (G,E,C,d)
    out = _expert_ffn(buf, {"w_gate": w_gate, "w_up": w_up,
                            "w_down": w_down})                   # (G,E,C,d)
    # combine: each token's k slots gathered back and summed over k
    picked = _Combine.apply(out, slot, kept, src, slot_valid)    # (G,m,d)
    w = wts.reshape(g, m)[..., None].to(out.dtype)
    return (picked * w).reshape(g, tg, k, -1).sum(dim=2)         # (G,Tg,d)


class _SumOverModel(torch.autograd.Function):
    """The model-axis sum of each rank's experts' partial combine (an
    all-reduce); its backward hands every rank the whole gradient (the sum
    feeds computation replicated over the axis)."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _experts_on_mesh(xg, src, slot_valid, slot, kept, wts, params, k: int):
    """:func:`_experts`; on a bound mesh under ``local_map``, as an
    expert-parallel block: each rank dispatches its data shard's groups to
    the experts its model shard holds (a gather of replicated tokens: no
    wire), runs them, combines their share of each token and sums the
    shares over the model axis (one all-reduce of (G, Tg, d), the
    reference's combine wire).  Experts the model axis does not divide
    run whole on every rank."""
    ws = (params["w_gate"], params["w_up"], params["w_down"])
    am = abstract_mesh()
    if am is None or not isinstance(xg, DTensor):
        return _experts(xg, src, slot_valid, slot, kept, wts, *ws, k)
    dp = dp_axes() if _div(xg.shape[0], am, dp_axes()) else ()
    n_model = model_shards(am)
    split = n_model > 1 and _div(ws[0].shape[0], am, "model")
    rows = to_placements(P(dp), am)
    names = list(am.mesh_dim_names)
    mdim = names.index("model")
    wpl = to_placements(P("model" if split else None), am)
    # gradients: a token's and a routing weight's are partial over the
    # model axis when each rank holds only some experts; an expert
    # weight's partial over the data axes (each shard's own tokens)
    part = lambda pl, dims: tuple(  # noqa: E731
        Partial() if j in dims else p for j, p in enumerate(pl))
    dp_dims = [names.index(a) for a in dp_axes()]
    row_grad = part(rows, [mdim] if split else [])
    w_grad = part(wpl, dp_dims)
    first = am.get_local_rank("model") * (ws[0].shape[0] // n_model) \
        if split else 0
    group = am.get_group("model")

    def body(xl, sl, vl, tl, kl, wl, *wsl):
        xl, wl = _ContiguousGrad.apply(xl), _ContiguousGrad.apply(wl)
        wsl = [_ContiguousGrad.apply(t) for t in wsl]
        out = _experts(xl, sl, vl, tl, kl, wl, *wsl, k, first)
        return _SumOverModel.apply(out, group) if split else out
    return local_map(
        body, out_placements=(rows,),
        in_placements=(rows,) * 6 + (wpl,) * 3,
        in_grad_placements=(row_grad,) + (rows,) * 4 + (row_grad,)
        + (w_grad,) * 3,
        device_mesh=am, redistribute_inputs=True)(
            xg, src, slot_valid, slot, kept, wts, *ws)


def _group_dispatch_dense(xg, ids, wts, params, e: int, capacity: int):
    """GShard-style dense one-hot dispatch of one group (the baseline)."""
    tg, k = ids.shape
    onehot = F.one_hot(ids.long(), e).to(torch.int32)        # (Tg, k, E)
    pos = (torch.cumsum(onehot.reshape(tg * k, e), 0, dtype=torch.int32)
           .reshape(tg, k, e) - onehot)
    kept = (pos < capacity) & (onehot > 0)
    # a slot past the end is all zeros (``jax.nn.one_hot``'s out of range)
    poh = F.one_hot(torch.where(kept, pos, capacity).long(),
                    capacity + 1)[..., :capacity].to(xg.dtype)  # (Tg,k,E,C)
    mask = poh * kept[..., None].to(xg.dtype)
    buf = torch.einsum("tkec,td->ecd", mask, xg)             # dense scatter
    out = _expert_ffn(buf, params)
    per_assign = torch.einsum("tkec,ecd->tkd", mask, out)
    return torch.sum(per_assign * wts[..., None].to(out.dtype), dim=1)


def moe_layer(params, x, cfg, *, groups: int = 1,
              engine: Optional[str] = None):
    """x: (B, S, d) -> (B, S, d), aux loss scalar.  ``engine`` selects the
    dispatch's partition engine (``None``: the kernels on CUDA, argsort on
    the CPU)."""
    b, s, d = x.shape
    t = b * s
    g = groups if t % groups == 0 else 1
    dp = dp_axes()
    # tokens whole on each data shard: DTensor cannot fold a
    # sequence-sharded stream into groups (a strided shard)
    x = constrain(x, P(dp, None, None))
    x_flat = x.reshape(t, d)
    wts, ids, aux = _route(x_flat, params["router"], cfg.top_k)
    wts = constrain(wts, P(dp, None))      # keep routing tables token-sharded
    ids = constrain(ids, P(dp, None))
    tg = t // g
    capacity = max(4, int(cfg.capacity_factor * tg * cfg.top_k
                          / cfg.num_experts))
    capacity = min(capacity, tg * cfg.top_k)
    xg = x_flat.reshape(g, tg, d)
    ids_g = ids.reshape(g, tg, cfg.top_k)
    wts_g = wts.reshape(g, tg, cfg.top_k)
    if cfg.moe_dispatch == "sort":
        out = _sort_dispatch(xg, ids_g, wts_g, params, cfg.num_experts,
                             capacity, engine)
    else:
        out = torch.stack([
            _group_dispatch_dense(xg[i], ids_g[i], wts_g[i], params,
                                  cfg.num_experts, capacity)
            for i in range(g)])
    # whole tokens per data shard on the way back too (the gradient of a
    # sequence-sharded stream cannot be unfolded into groups)
    return constrain(out.reshape(b, s, d), P(dp, None, None)), aux


# --- contract declaration (verified by repro_torch.analysis; see
# analysis/contracts)
# The sort-path MoE dispatch is one capacity_dispatch per token group: ONE
# counting pass (prologue histogram + fused launch) with the iota
# permutation riding as the single value leaf.
ANALYSIS_CONTRACT = {
    "entry": "repro_torch.core.segmented.capacity_dispatch",
    "census": {
        "launch_total": "2",
        "while_body_launches": "[]",
        "fused_grid": "ceil_div(g_max, B)",
    },
    "sort_free": True,
    "donation": {"_fused_pass_kernel": "1 + vals"},
    "transfer": {
        "sweep_kernels": ["_hist_kernel", "_fused_pass_kernel"],
        "bytes": "(2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb",
    },
}
