"""Mamba2 SSD (state-space duality) layer — chunked training + O(1) decode:
port of ``repro.models.ssm``.

Follows the SSD block decomposition of arXiv:2405.21060: within-chunk terms
are attention-like masked contractions, cross-chunk terms propagate a
(heads, head_dim, state) recurrence (the reference's ``lax.scan`` over
chunks, here a Python loop).  The four-operand contractions go through
``torch.einsum``, whose contraction order differs from XLA's: results agree
with the reference to float32 rounding, not bit for bit.

On a mesh (``launch.mesh.use_mesh``) the projections are DTensor products
and the scan between them runs under ``local_map`` (``layers.
local_on_mesh``): each rank scans its data shard's sequences with every
head, the projection gathered whole over the model axis (the rules shard
``in_proj`` over it only where the columns divide, and the scan's
head-mixing contractions are not ones DTensor can split).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, local_on_mesh, normal,
                                       rms_norm)

_F32 = torch.float32
CONV_K = 4  # short depthwise causal conv window (mamba standard)


class SSMCache(NamedTuple):
    state: torch.Tensor       # (B, H, P, N) float32
    conv: torch.Tensor        # (B, CONV_K - 1, conv_dim) last inputs


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm(generator, cfg, dtype, device=None):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h                 # z, x, B, C, dt
    return {
        "in_proj": dense_init(generator, d, proj_out, dtype, device=device),
        "conv_w": normal(generator, (CONV_K, conv_dim(cfg)), dtype, device,
                         scale=0.1),
        "A_log": torch.zeros(h, dtype=_F32, device=device),   # A = -1
        "D": torch.ones(h, dtype=_F32, device=device),
        "dt_bias": torch.zeros(h, dtype=_F32, device=device),
        "norm_w": torch.ones(di, dtype=_F32, device=device),
        "out_proj": dense_init(generator, di, d, dtype, device=device),
    }


def _split_proj(proj, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w):
    """Depthwise causal conv over time. xbc: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out)


def _segsum(x):
    """(..., Q) -> (..., Q, Q) segment sums: out[i, j] = sum_{j<t<=i} x_t,
    -inf above the diagonal (``exp`` of it is 0; nothing multiplies it)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=x.device)[:, None]
    jj = torch.arange(q, device=x.device)[None, :]
    return seg.masked_fill(jj > ii, -torch.inf)


def ssm_forward(params, x, cfg, return_cache: bool = False):
    """Chunked SSD scan. x: (B, S, d) -> (B, S, d) (+ SSMCache for prefill).

    Sequences not divisible by the chunk length are zero-padded at the tail;
    causality keeps the padded positions from influencing real outputs.
    """
    s_orig = x.shape[1]
    q = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    proj = x @ params["in_proj"]
    y, state, conv_tail = local_on_mesh(
        lambda *t: _ssd(*t, cfg=cfg, cache=return_cache and not pad),
        (proj, *(params[k] for k in _CORE)), rows=1, outs=3)
    out = y @ params["out_proj"]
    out = out[:, :s_orig] if pad else out
    if not return_cache:
        return out
    # exact state handoff needs no tail padding (pad positions would apply
    # spurious decay); prefill shapes are chunk-aligned by construction
    assert pad == 0 and s_orig >= CONV_K - 1, "prefill must be chunk-aligned"
    return out, SSMCache(state=state, conv=conv_tail)


#: the scan's parameters (whole on every rank on a mesh)
_CORE = ("conv_w", "dt_bias", "A_log", "D", "norm_w")


def _ssd(proj, conv_w, dt_bias, a_log, d_skip, norm_w, *, cfg, cache):
    """The chunked scan from the input projection (B, S, 2di+2n+h) to the
    normed output (B, S, di), and (when ``cache``) the final state and the
    conv inputs' tail; otherwise those two are empty."""
    b, s, _ = proj.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    z, xbc, dt = _split_proj(proj, cfg)
    xbc_raw = xbc                      # pre-conv inputs feed the decode cache
    xbc = _causal_conv(xbc, conv_w)
    xin = xbc[..., :di].reshape(b, s, h, p)
    bmat = xbc[..., di:di + n]                          # (B, S, N) one group
    cmat = xbc[..., di + n:]
    dt = F.softplus(dt.to(_F32) + dt_bias)              # (B, S, H)
    a = -torch.exp(a_log)                               # (H,)
    da = dt * a                                         # (B, S, H)

    # chunk views
    xin_c = xin.reshape(b, nc, q, h, p).to(_F32)
    b_c = bmat.reshape(b, nc, q, n).to(_F32)
    c_c = cmat.reshape(b, nc, q, n).to(_F32)
    dt_c = dt.reshape(b, nc, q, h)
    da_c = da.reshape(b, nc, q, h)
    cum = torch.cumsum(da_c, dim=2)                     # (B, NC, Q, H)

    # ---- intra-chunk (attention-like) term ----
    lmask = torch.exp(_segsum(da_c.permute(0, 1, 3, 2)))    # (B,NC,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)      # (B,NC,Q,Q)
    y_intra = torch.einsum("bcij,bchij,bcjh,bcjhp->bcihp",
                           scores, lmask, dt_c, xin_c)

    # ---- chunk states + inter-chunk recurrence ----
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (B,NC,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn",
                          b_c, dt_c * decay_states, xin_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,NC,H)

    state = torch.zeros((b, h, p, n), dtype=_F32, device=proj.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,P,N)

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp",
                           c_c, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + d_skip[None, None, :, None] * xin.to(_F32)
    y = y.reshape(b, s, di).to(proj.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, norm_w.to(proj.dtype), cfg.rms_eps)
    if not cache:
        return y, state[:0], xbc_raw[:0]
    return y, state, xbc_raw[:, s - (CONV_K - 1):, :]


def ssm_decode_step(params, x, cache: SSMCache, cfg):
    """One-token step. x: (B, 1, d); O(1) state update (no KV growth)."""
    proj = x[:, 0] @ params["in_proj"]
    y, state, new_conv = local_on_mesh(
        lambda *t: _ssd_step(*t, cfg=cfg),
        (proj, cache.state, cache.conv, *(params[k] for k in _CORE)),
        rows=3, outs=3)
    out = (y @ params["out_proj"])[:, None, :]
    return out, SSMCache(state=state, conv=new_conv)


def _ssd_step(proj, state, conv, conv_w, dt_bias, a_log, d_skip, norm_w, *,
              cfg):
    """One token of the scan: (normed output (B, di), state, conv tail)."""
    b = proj.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(proj, cfg)

    conv_in = torch.cat([conv, xbc[:, None, :]], dim=1)         # (B, K, C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, conv_w))
    new_conv = conv_in[:, 1:, :]

    xin = xbc[..., :di].reshape(b, h, p).to(_F32)
    bvec = xbc[..., di:di + n].to(_F32)
    cvec = xbc[..., di + n:].to(_F32)
    dt = F.softplus(dt.to(_F32) + dt_bias)              # (B, H)
    a = -torch.exp(a_log)
    da = torch.exp(dt * a)                              # (B, H)

    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xin, bvec)
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cvec)
    y = y + d_skip[None, :, None] * xin
    y = y.reshape(b, di).to(proj.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, norm_w.to(proj.dtype), cfg.rms_eps)
    return y, state, new_conv


def init_ssm_cache(cfg, batch: int, dtype, device=None):
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return SSMCache(
        state=torch.zeros((batch, h, p, n), dtype=_F32, device=device),
        conv=torch.zeros((batch, CONV_K - 1, conv_dim(cfg)), dtype=dtype,
                         device=device))
