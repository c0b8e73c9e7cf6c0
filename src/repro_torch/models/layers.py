"""Shared transformer building blocks (RMSNorm, RoPE, GQA attention, SwiGLU):
port of ``repro.models.layers``.

Functional style as in the reference: ``init_*`` build plain dicts of
tensors, drawing from an explicit ``torch.Generator``; the apply functions
are pure and run on the device of their inputs.  The mesh hooks
(``abstract_mesh``, ``dp_axes``, ``constrain``) read the mesh that
``launch.mesh.use_mesh`` binds, the counterpart of the reference's
``jax.set_mesh``: off a mesh they are no-ops.

Numerics follow the reference: norms, RoPE and softmax in float32;
attention scores and the value product accumulate in float32 (the
reference's ``preferred_element_type``), the probabilities cast to the
values' dtype first; masked scores take -1e30, not -inf.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.mesh import bound_mesh, model_shards
from repro_torch.launch.sharding import P, _div, to_placements

_F32 = torch.float32
#: the reference's masked-score value
_MASKED = -1e30


def normal(generator, shape, dtype, device=None, scale: float = 0.02):
    """float32 normal draws times ``scale``, cast to ``dtype`` (the
    reference's ``(jax.random.normal(...) * scale).astype(dtype)``)."""
    out = torch.randn(shape, generator=generator, dtype=_F32, device=device)
    return (out.mul_(scale)).to(dtype)


def dense_init(generator, in_dim: int, out_dim: int, dtype, scale=0.02,
               device=None):
    return normal(generator, (in_dim, out_dim), dtype, device, scale)


def abstract_mesh():
    """The ``DeviceMesh`` bound by ``launch.mesh.use_mesh``, or None."""
    return bound_mesh()


def dp_axes():
    """Batch-carrying mesh axes of the bound mesh (() off-mesh)."""
    am = abstract_mesh()
    names = tuple(am.mesh_dim_names or ()) if am is not None else ()
    return tuple(a for a in ("pod", "data") if a in names)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint`` that no-ops off-mesh:
    under a bound mesh a DTensor is redistributed to ``spec``'s placements
    (a partial sum is reduced on the way), and so is its gradient in the
    backward; a plain tensor, or a spec naming an axis the mesh lacks,
    passes through unchanged."""
    am = abstract_mesh()
    if am is None or not isinstance(x, DTensor):
        return x
    names = set(am.mesh_dim_names or ())
    used = {a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))}
    if not used or not used.issubset(names):
        return x
    # a dim the named axes do not divide stays whole (DTensor's uneven
    # shards cannot be reshaped; GSPMD pads them)
    spec = P(*(part if part is None or _div(n, am, part) else None
               for n, part in zip(x.shape, spec)))
    # always through ``redistribute``, even to the same placements: its
    # backward puts the gradient in those placements too, as the
    # reference's constraint binds the cotangent
    return x.redistribute(am, to_placements(spec, am))


def gather_data_shards(tree):
    """FSDP's unshard of one block's parameters: on a bound mesh each
    DTensor leaf stored sharded over the data axes (the ``fsdp_params``
    rules) is all-gathered over them, its model-axis sharding kept; the
    backward reduce-scatters the gradient back.  Off a mesh, ``tree``."""
    am = abstract_mesh()
    if am is None:
        return tree
    names = list(am.mesh_dim_names)
    dims = [names.index(a) for a in dp_axes()]

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if not isinstance(t, DTensor) or all(
                t.placements[j].is_replicate() for j in dims):
            return t
        pl = [Replicate() if j in dims else p
              for j, p in enumerate(t.placements)]
        return t.redistribute(am, pl)
    return go(tree)


def rms_norm(x, weight, eps: float):
    xf = x.to(_F32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.to(_F32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int32.  Rotates the two
    halves of each head (not interleaved pairs), as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].to(_F32) * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------- GQA attention ----------------------------------

def init_attention(generator, cfg, dtype, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads_padded, cfg.n_kv_padded   # TP head padding (config)
    return {
        "wq": dense_init(generator, d, h * hd, dtype, device=device),
        "wk": dense_init(generator, d, kv * hd, dtype, device=device),
        "wv": dense_init(generator, d, kv * hd, dtype, device=device),
        "wo": dense_init(generator, h * hd, d, dtype, device=device),
    }


def _pad_head_mask(cfg, device=None):
    """Validity mask over padded Q heads: pad heads contribute exactly zero,
    so the padded model computes the unpadded architecture."""
    h, kv = cfg.n_heads_padded, cfg.n_kv_padded
    n_rep = h // kv
    rep_real = cfg.n_heads // cfg.n_kv_heads
    hidx = torch.arange(h, device=device)
    return (hidx // n_rep < cfg.n_kv_heads) & (hidx % n_rep < rep_real)


def _head_cols(n_heads: int):
    """Spec of a (B, S, heads * hd) projection on the bound mesh: batch over
    the data axes, heads over the model axis when it divides them."""
    am = abstract_mesh()
    heads = "model" if am is not None and n_heads % model_shards(am) == 0 \
        else None
    return P(dp_axes(), None, heads)


def _gqa_scores(q, k, n_rep: int):
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> (B,H,S,T) float32.

    Q head h reads KV head h // n_rep (the reference's ``jnp.repeat`` of
    the KV heads), here by viewing H as (KV, n_rep) instead of copying the
    KV heads."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.to(_F32).reshape(b, s, kvh, n_rep, hd)
    out = torch.einsum("bsgrd,btgd->bgrst", qg, k.to(_F32))
    return out.reshape(b, h, s, k.shape[1])


def _gqa_values(probs, v, n_rep: int):
    """probs: (B,H,S,T) in v.dtype, v: (B,T,KV,hd) -> (B,S,H,hd) float32."""
    b, h, s, t = probs.shape
    kvh = v.shape[2]
    pg = probs.to(_F32).reshape(b, kvh, n_rep, s, t)
    out = torch.einsum("bgrst,btgd->bsgrd", pg, v.to(_F32))
    return out.reshape(b, s, h, v.shape[-1])


def _attend(q, k, v, n_rep: int, scale: float, cfg, *, positions=None,
            window: Optional[int] = None, cache_len: Optional[int] = None):
    """The attention core: (B,S,H,hd) queries against (B,T,KV,hd) keys and
    values -> (B,S,H,hd) float32.  ``cache_len`` None: causal over
    ``positions`` ((1, S); the naive or the flash form); else the decode
    mask over the T cache rows."""
    if cache_len is None and getattr(cfg, "attention_impl", "naive") == "flash":
        k_rep = k.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k
        v_rep = v.repeat_interleave(n_rep, dim=2) if n_rep > 1 else v
        return flash_attention(q, k_rep, v_rep, positions, window,
                               min(cfg.flash_block, q.shape[1]))
    scores = _gqa_scores(q, k, n_rep) / scale
    if cache_len is None:
        ii = positions[:, None, :, None]              # query pos
        jj = positions[:, None, None, :]              # key pos
        mask = jj <= ii
        if window:                                    # 0 = full
            mask &= jj > ii - window
    else:
        jj = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
        mask = jj <= cache_len
        if window:
            mask &= jj > cache_len - window
    scores = scores.masked_fill(~mask, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_values(probs, v, n_rep)


def _attend_on_mesh(q, k, v, n_rep: int, scale: float, cfg, **kw):
    """:func:`_attend`, on a bound mesh under ``local_map``: each rank
    attends with its own heads (its data shard's batch, its model shard's
    Q heads, and the KV heads they read), as a Megatron block does, so the
    score tensors never leave the rank.  Where the model axis divides the Q
    heads but not the KV heads, the KV heads are whole on every rank and
    each rank picks the ones its Q heads read."""
    am = abstract_mesh()
    if am is None or not isinstance(q, DTensor):
        return _attend(q, k, v, n_rep, scale, cfg, **kw)
    h, kvh, m = q.shape[2], k.shape[2], model_shards(am)
    dp = dp_axes() if _divides(q.shape[0], am, dp_axes()) else None
    heads = "model" if h % m == 0 else None
    kv_heads = "model" if heads and kvh % m == 0 else None
    qp = to_placements(P(dp, None, heads, None), am)
    kp = to_placements(P(dp, None, kv_heads, None), am)
    pick = heads is not None and kv_heads is None
    first = am.get_local_rank("model") * (h // m) if pick else 0

    def body(ql, kl, vl):
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if not pick:
            return _attend(ql, kl, vl, n_rep, scale, cfg, **kw)
        # the KV head each of this rank's Q heads reads
        kv_of = torch.div(torch.arange(first, first + ql.shape[2],
                                       device=ql.device), n_rep,
                          rounding_mode="floor")
        return _attend(ql, kl.index_select(2, kv_of),
                       vl.index_select(2, kv_of), 1, scale, cfg, **kw)
    return local_map(body, out_placements=(qp,), in_placements=(qp, kp, kp),
                     device_mesh=am, redistribute_inputs=True)(q, k, v)


def local_on_mesh(fn, args, rows: int, outs: int):
    """``fn(*args)``, which returns ``outs`` batch-leading tensors.  On a
    bound mesh, with DTensor arguments, under ``local_map``: the first
    ``rows`` arguments and the outputs split over the data axes by their
    leading (batch) dim where it divides (else whole), the other arguments
    whole on every rank, the model axis replicated throughout."""
    am = abstract_mesh()
    if am is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    dp = dp_axes() if _divides(args[0].shape[0], am, dp_axes()) else None
    split, whole = to_placements(P(dp), am), to_placements(P(), am)

    def body(*local):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in local))
    return local_map(body, out_placements=(split,) * outs,
                     in_placements=(split,) * rows
                     + (whole,) * (len(args) - rows),
                     device_mesh=am, redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: a local
    gradient leaving ``local_map`` becomes a DTensor whose strides are
    taken as contiguous, and the einsum backward's permuted layouts would
    break the views that follow."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _divides(n: int, mesh, axes) -> bool:
    return bool(axes) and _div(n, mesh, axes)


def attention(params, x, cfg, *, positions=None, kv_cache=None,
              cache_len: Optional[int] = None, window: Optional[int] = None):
    """GQA attention in the reference's two modes:

      train/prefill: ``kv_cache=None`` — full causal self-attention
        (limited to ``window`` past keys when ``window`` > 0);
      decode: ``kv_cache=(k, v)`` of static length T — ``x`` is (B, S, d),
        ``cache_len`` (a Python int) the number of valid cache entries; the
        new keys go to rows ``cache_len ..`` of a copy of the cache, the
        start clamped so they fit (``jax.lax.dynamic_update_slice``).

    Returns ``(out, (k, v))``: the new keys and values (prefill) or the
    updated cache (decode).
    """
    b, s, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads_padded, cfg.n_kv_padded
    n_rep = h // kvh
    padded = bool(cfg.head_pad_to or cfg.kv_pad_to)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None, :]
    scale = math.sqrt(hd)

    # on a mesh, heads over the model axis before the head split (or whole
    # heads on each rank, where the axis does not divide them)
    q = constrain(x @ params["wq"], _head_cols(h)).reshape(b, s, h, hd)
    k = constrain(x @ params["wk"], _head_cols(kvh)).reshape(b, s, kvh, hd)
    v = constrain(x @ params["wv"], _head_cols(kvh)).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = _attend_on_mesh(q, k, v, n_rep, scale, cfg,
                              positions=positions, window=window)
        new_cache = (k, v)
    else:
        ck, cv = kv_cache                                 # (B, T, KV, hd)
        t = ck.shape[1]
        start = min(max(int(cache_len), 0), t - s)
        ck, cv = ck.clone(), cv.clone()
        ck[:, start:start + s] = k
        cv[:, start:start + s] = v
        out = _attend_on_mesh(q, ck, cv, n_rep, scale, cfg,
                              cache_len=cache_len, window=window)
        new_cache = (ck, cv)

    if padded:
        out = out * _pad_head_mask(cfg, x.device)[None, None, :, None].to(
            out.dtype)
    out = out.reshape(b, s, h * hd).to(x.dtype) @ params["wo"]
    return out, new_cache


# --------------------------- flash attention --------------------------------

def flash_attention(q, k, v, positions, window, block: int):
    """Blockwise online-softmax attention (Rabe & Staats / FlashAttention).

    q: (B,S,H,hd); k, v already KV-head-broadcast to (B,T,H,hd).  The KV
    axis streams in ``block``-sized tiles with a running max and
    denominator (the reference's ``lax.scan`` as a Python loop)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    pad = (-t) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = k.shape[1] // block
    scale = 1.0 / math.sqrt(hd)
    ii = positions[:, None, :, None]                       # (B,1,S,1)
    qf = q.to(_F32)
    m = torch.full((b, h, s), -math.inf, dtype=_F32, device=q.device)
    l = torch.zeros((b, h, s), dtype=_F32, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=_F32, device=q.device)
    for i in range(nblk):
        t0 = i * block
        kblk, vblk = k[:, t0:t0 + block], v[:, t0:t0 + block]
        sblk = torch.einsum("bshd,bthd->bhst", qf, kblk.to(_F32)) * scale
        jj = (t0 + torch.arange(block, dtype=torch.int32,
                                device=q.device))[None, None, None, :]
        mask = (jj <= ii) & (jj < t)
        if window:
            mask &= jj > ii - window
        sblk = sblk.masked_fill(~mask, _MASKED)
        m_new = torch.maximum(m, sblk.amax(dim=-1))
        p = torch.exp(sblk - m_new[..., None])             # (B,H,S,blk)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p.to(vblk.dtype).to(_F32),
                          vblk.to(_F32))
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]


def np_sqrt(x):
    """Host square root of a Python number (the reference's helper)."""
    return math.sqrt(x)


# --------------------------- SwiGLU MLP -------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, dtype, device=None):
    return {"w_gate": dense_init(generator, d_model, d_ff, dtype,
                                 device=device),
            "w_up": dense_init(generator, d_model, d_ff, dtype,
                               device=device),
            "w_down": dense_init(generator, d_ff, d_model, dtype,
                                 device=device)}


def mlp(params, x):
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ \
        params["w_down"]
