"""Optimizers built from scratch: AdamW, Adafactor, 8-bit AdamW (port of
``repro.optim.optimizers``).

The three tiers trade per-parameter state bytes for fidelity:

  adamw      m,v fp32            + 8 B/param   (default)
  adamw8bit  m,v int8 + scales   + ~2 B/param  (block-quantised states)
  adafactor  v factored row/col  + ~0 B/param  (kimi-k2 tier)

API as in the reference: ``opt.init(params) -> state``;
``opt.update(grads, state, params, lr) -> (params, state)``.

**The update works in place.**  It writes the new values into the given
parameter and state tensors under ``torch.no_grad()`` and returns those
same tensors: the port's counterpart of the reference's donated buffers.
It walks the tree one leaf at a time, so the float32 temporaries of one
leaf are freed before the next (at Qwen3-30B-A3B's width one expert leaf
is 201 M parameters).  Callers that need the old values pass copies.
``clip_by_global_norm`` scales the gradients in place for the same
reason.  ``lr`` may be a Python float or a 0-d tensor on the parameters'
device; nothing is read back to the host.

The tree is the port's own: dicts (walked in sorted key order, as
``jax.tree`` orders them), lists and tuples, with tensors as leaves.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.interop import tree_flatten

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, lr) -> (params, state)


def _walk(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the nodes at the same place in
    ``rest`` (which may be subtrees: the per-leaf state dicts)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def clip_by_global_norm(grads, max_norm: float):
    """Global-norm clip without an f32 copy of the gradients: the norm
    accumulates in float32 scalars (leaves in sorted-key order, as the
    reference sums them); each leaf is scaled in place in its own dtype.
    Returns ``(grads, norm)``, the norm a 0-d float32 tensor."""
    leaves, _ = tree_flatten(grads)
    with torch.no_grad():
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                            for g in leaves))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        for g in leaves:
            g.mul_(scale.to(g.dtype))
    return grads, gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up from 0 (the first step's lr is 0), then cosine decay;
    ``step`` an int or a tensor, the result a float32 tensor on its
    device."""
    def lr(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=_F32)


def _count(params):
    leaves, _ = tree_flatten(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# --------------------------------- AdamW ------------------------------------

def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        return {"m": _walk(_zeros_f32, params), "v": _walk(_zeros_f32, params),
                "count": _count(params)}

    def update(grads, state, params, lr):
        with torch.no_grad():
            state["count"].add_(1)
            c = state["count"].to(_F32)
            bc1 = 1 - b1 ** c
            bc2 = 1 - b2 ** c

            def upd(p, g, m, v):
                g = g.to(_F32)
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                del g
                step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                p32 = p.to(_F32)
                step = step + weight_decay * p32
                p.copy_(p32 - lr * step)
                return p

            _walk(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


# ------------------------------- Adafactor ----------------------------------

def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8, weight_decay=0.0):
    """Factored second moments: O(rows+cols) state for every leaf of two or
    more dims (the (E, d, f) expert weights get ``vr`` (E, d) and ``vc``
    (E, f)); a dense ``v`` for vectors and 0-d leaves.  ``rsqrt`` is
    ``torch.rsqrt`` (the reference's ``jax.lax.rsqrt``)."""
    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=_F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=_F32, device=p.device)}
            return {"v": _zeros_f32(p)}
        return {"s": _walk(st, params), "count": _count(params)}

    def update(grads, state, params, lr):
        with torch.no_grad():
            state["count"].add_(1)
            c = state["count"].to(_F32)
            beta = 1.0 - (c + 1.0) ** (-decay)

            def upd(p, g, s):
                g = g.to(_F32)
                g2 = torch.square(g) + eps
                if _factored(p.shape):
                    s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
                    s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
                    del g2
                    vr, vc = s["vr"], s["vc"]
                    denom = vr.mean(dim=-1, keepdim=True)
                    # factored rsqrt: never the dense (rows x cols) vhat
                    rs_r = torch.rsqrt(torch.clamp(
                        vr / torch.clamp(denom, min=eps), min=eps))
                    rs_c = torch.rsqrt(torch.clamp(vc, min=eps))
                    u = g * rs_r[..., None] * rs_c[..., None, :]
                else:
                    s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                    del g2
                    u = g * torch.rsqrt(torch.clamp(s["v"], min=eps))
                del g
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                p32 = p.to(_F32)
                u = u + weight_decay * p32
                p.copy_(p32 - lr * u)
                return p

            _walk(upd, params, grads, state["s"])
        return params, state

    return Optimizer(init, update)


# ------------------------------- 8-bit AdamW --------------------------------

_BLOCK = 256


def _quant(x):
    """int8 blocks of 256 (zero-padded) with float32 scales max|x|/127;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    fb = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = fb.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(fb / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.to(_F32)


def _dequant(q, scale, shape):
    flat = (q.to(_F32) * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def adamw8bit(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """AdamW with block-quantised int8 m/v states (~2 B/param instead of 8)."""
    def init(params):
        def st(p):
            q, s = _quant(_zeros_f32(p))
            return {"mq": q, "ms": s, "vq": q.clone(), "vs": s.clone()}
        return {"s": _walk(st, params), "count": _count(params)}

    def update(grads, state, params, lr):
        with torch.no_grad():
            state["count"].add_(1)
            c = state["count"].to(_F32)
            bc1 = 1 - b1 ** c
            bc2 = 1 - b2 ** c

            def upd(p, g, s):
                g = g.to(_F32)
                m = b1 * _dequant(s["mq"], s["ms"], p.shape) + (1 - b1) * g
                v = (b2 * _dequant(s["vq"], s["vs"], p.shape)
                     + (1 - b2) * torch.square(g))
                del g
                step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                for name, x in (("m", m), ("v", v)):
                    q, sc = _quant(x)
                    s[name + "q"].copy_(q)
                    s[name + "s"].copy_(sc)
                del m, v
                p32 = p.to(_F32)
                step = step + weight_decay * p32
                p.copy_(p32 - lr * step)
                return p

            _walk(upd, params, grads, state["s"])
        return params, state

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor,
            "adamw8bit": adamw8bit}[name](**kw)
