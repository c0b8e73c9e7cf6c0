"""Shared transformer building blocks (RMSNorm, RoPE, GQA attention, SwiGLU):
port of ``repro.models.layers``.

Functional style as in the reference: ``init_*`` build plain dicts of
tensors, drawing from an explicit ``torch.Generator``; the apply functions
are pure and run on the device of their inputs.  The reference's mesh hooks
(``abstract_mesh``, ``dp_axes``, ``constrain``) are not ported: off a mesh
they are no-ops, and the port runs on one device.

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

    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if getattr(cfg, "attention_impl", "naive") == "flash":
            k_rep = k.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k
            v_rep = v.repeat_interleave(n_rep, dim=2) if n_rep > 1 else v
            out = flash_attention(q, k_rep, v_rep, positions, window,
                                  min(cfg.flash_block, s))
        else:
            scores = _gqa_scores(q, k, n_rep) / scale
            ii = positions[:, None, :, None]              # query pos
            jj = positions[:, None, None, :]              # key pos
            mask = jj <= ii
            if window:                                    # 0 = full
                mask &= jj > ii - window
            scores = scores.masked_fill(~mask, _MASKED)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            out = _gqa_values(probs, v, n_rep)
        new_cache = (k, v)
    else:
        ck, cv = kv_cache                                 # (B, T, KV, hd)
        t = ck.shape[1]
        start = min(max(int(cache_len), 0), t - s)
        ck, cv = ck.clone(), cv.clone()
        ck[:, start:start + s] = k
        cv[:, start:start + s] = v
        scores = _gqa_scores(q, ck, n_rep) / scale
        jj = torch.arange(t, device=x.device)[None, None, None, :]
        valid = jj <= cache_len
        if window:
            valid &= jj > cache_len - window
        scores = scores.masked_fill(~valid, _MASKED)
        probs = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = _gqa_values(probs, cv, n_rep)
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
