"""Config-driven model assembly for all assigned architecture families: port
of ``repro.models.transformer``.

Families:
  dense  — pre-norm GQA + SwiGLU (internlm2, deepseek, phi4; musicgen over
           EnCodec-token stub; internvl2 with patch-embedding stub frontend)
  moe    — GQA + sort-dispatched MoE FFN (qwen3-moe, kimi-k2)
  ssm    — Mamba2 SSD blocks, attention-free
  hybrid — Hymba: parallel attention+SSM heads per block, SWA except listed
           global layers, + SwiGLU FFN

The reference stacks its layers along a leading L dim and scans them; the
port keeps one dict of tensors per layer (``params["layers"]``, a list) and
loops over them in Python, and its decode cache holds one tensor per layer
(tuples) with a Python-int ``length``, so a decode step reads nothing back
from the device.  ``params_from_reference`` carries the reference's
parameters across.

Gradients: parameters are plain leaf tensors (``requires_grad_()`` on
them, or on copies), and ``torch.autograd`` differentiates ``loss_fn`` as
``jax.grad`` does the reference's.  ``remat=True`` wraps each block in
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint(body)``: the backward recomputes the block, so an MoE
layer's dispatch runs a second time.  ``remat_policy="save_block_io"``
checkpoints each sub-layer instead, so the attention and FFN outputs are
kept, as the reference's policy keeps ``attn_out`` and ``ffn_out``.
``engine`` (``forward``, ``loss_fn``, ``decode_step``) selects the MoE
dispatch's partition engine (``None``: the kernels on CUDA, argsort on
the CPU), which ``ServeEngine`` and the trainer set.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import torch_dtype
from repro_torch.core.interop import resolve_device, to_tensor
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.launch.mesh import model_shards
from repro_torch.launch.sharding import P, _div, to_placements

_F32 = torch.float32
_ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")


# ----------------------------- init -----------------------------------------

def _init_block(gen, cfg, dtype, device):
    p: Dict[str, Any] = {}
    d = cfg.d_model
    ones = lambda: torch.ones(d, dtype=_F32, device=device)  # noqa: E731
    if cfg.family in _ATTN_FAMILIES:
        p["attn_norm"] = ones()
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
        p["ffn_norm"] = ones()
        if cfg.is_moe:
            p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, device)
    elif cfg.family == "ssm":
        p["norm"] = ones()
        p["ssm"] = SSM.init_ssm(gen, cfg, dtype, device)
    elif cfg.family == "hybrid":
        p["in_norm"] = ones()
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
        p["ssm"] = SSM.init_ssm(gen, cfg, dtype, device)
        p["b_attn"] = torch.tensor(0.5, dtype=_F32, device=device)
        p["b_ssm"] = torch.tensor(0.5, dtype=_F32, device=device)
        p["ffn_norm"] = ones()
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, device)
    else:
        raise ValueError(cfg.family)
    return p


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters with the reference's shapes, dtypes and scales
    (normal·0.02, ``conv_w`` normal·0.1, ``A_log`` 0, ``D`` 1, norms 1),
    drawn from ``generator`` (a ``torch.Generator`` on ``device``; seed 0
    when omitted).  ``device`` is the GPU unless the caller says otherwise;
    without one this raises.  The draws cannot match ``jax.random``:
    carry the reference's own parameters with ``params_from_reference``.
    On the ``meta`` device nothing is drawn: the tree holds the shapes and
    dtypes only (the dry run's stand-ins)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {
        "embed": L.normal(generator, (v, d), dtype, dev),
        "final_norm": torch.ones(d, dtype=_F32, device=dev),
        "layers": [_init_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, d, v, dtype, device=dev)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(cfg, params, device=None):
    """The port's parameters from the reference's ``init_params`` tree
    (numpy arrays, or arrays ``np.asarray`` takes; bfloat16 crosses as its
    bit pattern): the leading L dim of ``params["layers"]`` is un-stacked
    into one dict per layer.  Every leaf owns its storage (no views), so
    it can take ``requires_grad_()`` and in-place updates.  ``device`` as
    in :func:`init_params`."""
    dev = resolve_device(device)
    conv = lambda a: to_tensor(np.array(a), dev)  # noqa: E731
    own = lambda t: t.clone() if t._is_view() else t  # noqa: E731
    out = {k: own(conv(v)) for k, v in params.items() if k != "layers"}
    stacked = _tree_map(conv, params["layers"])
    out["layers"] = [_tree_map(lambda t, i=i: t[i].clone(), stacked)
                     for i in range(cfg.n_layers)]
    return out


def _windows(cfg) -> List[int]:
    """Per-layer attention window (0 = full attention)."""
    w = [cfg.attn_window] * cfg.n_layers
    for i in cfg.global_attn_layers:
        w[i] = 0
    return w


def cfg_groups(cfg) -> int:
    return cfg.dispatch_groups


def _stream(x):
    """The residual stream whole on each model rank: after a sub-layer's
    add (the reduction of a row-parallel product's partial sums, as a
    Megatron block all-reduces it) and where a block or the head reads a
    sequence-sharded carry (``_seq_shard``).  A no-op off a mesh."""
    return L.constrain(x, P(L.dp_axes(), None, None))


def _seq_shard(x, cfg):
    """Sequence-parallel residual stream (Korthikanti et al.): the carry
    between blocks is sharded over the model axis on the sequence dim, so
    remat checkpoints cost 1/|model| of the replicated layout; the next
    block gathers it whole (``_stream``).  A no-op off a mesh."""
    if not cfg.seq_shard_activations or x.shape[1] % 2:
        return x
    return L.constrain(x, P(L.dp_axes(), "model", None))


# ----------------------------- forward --------------------------------------

def _call(fn, *args):
    return fn(*args)


def _recompute(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint: only the inputs are
    kept, the rest is recomputed in the backward (no RNG in the models, so
    none is saved)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _attn_sub(bp, x, cfg, window, positions):
    h, _ = L.attention(bp["attn"], L.rms_norm(x, bp["attn_norm"],
                                              cfg.rms_eps),
                       cfg, positions=positions, window=window)
    return h


def _ffn_sub(bp, x, cfg, engine):
    y = L.rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
    if cfg.is_moe:
        return MOE.moe_layer(bp["moe"], y, cfg, groups=cfg_groups(cfg),
                             engine=engine)
    return L.mlp(bp["mlp"], y), None


def _ssm_sub(bp, x, cfg):
    return SSM.ssm_forward(bp["ssm"], L.rms_norm(x, bp["norm"], cfg.rms_eps),
                           cfg)


def _mix_sub(bp, x, cfg, window, positions):
    y = L.rms_norm(x, bp["in_norm"], cfg.rms_eps)
    a, _ = L.attention(bp["attn"], y, cfg, positions=positions,
                       window=window)
    s = SSM.ssm_forward(bp["ssm"], y, cfg)
    return (bp["b_attn"] * a.to(_F32) + bp["b_ssm"] * s.to(_F32)).to(x.dtype)


def _mlp_sub(bp, x, cfg):
    return L.mlp(bp["mlp"], L.rms_norm(x, bp["ffn_norm"], cfg.rms_eps))


def _block_fwd(bp, x, cfg, window, positions, engine=None, sub=_call):
    """One block; ``sub`` runs each sub-layer (``_recompute`` for the
    ``save_block_io`` policy, which keeps the sub-layers' outputs)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    bp = L.gather_data_shards(bp)
    x = _stream(x)             # a sequence-sharded carry, whole again
    if cfg.family in _ATTN_FAMILIES:
        x = _stream(x + sub(_attn_sub, bp, x, cfg, window, positions))
        m, a = sub(_ffn_sub, bp, x, cfg, engine)
        x = _stream(x + m)
        if a is not None:
            aux = a
    elif cfg.family == "ssm":
        x = _stream(x + sub(_ssm_sub, bp, x, cfg))
    elif cfg.family == "hybrid":
        x = _stream(x + sub(_mix_sub, bp, x, cfg, window, positions))
        x = _stream(x + sub(_mlp_sub, bp, x, cfg))
    return _seq_shard(x, cfg), aux


def _embed_rows(embed, ids):
    """The rows of the table ``embed`` (V, d) at the token ``ids``.

    ``F.embedding``'s backward adds each row's gradient contributions in a
    fixed order (on the CPU each thread owns a range of rows and walks the
    ids in order; on CUDA the ids are sorted and each row's segment
    summed), so a training step repeats bit for bit at any thread count.
    A DTensor table sharded over its vocab dim keeps the index form:
    DTensor's embedding backward fails on it, and the index form's CPU
    backward (``index_put`` with accumulate) adds in thread order."""
    ids = torch.as_tensor(ids, device=embed.device).long()
    if isinstance(embed, DTensor) and any(p.is_shard(0)
                                          for p in embed.placements):
        return embed[ids]
    return F.embedding(ids, embed)


def _embed_inputs(params, cfg, batch):
    """batch: {"tokens": (B,S)} (+ "patches": (B,P,d) for vlm); numpy
    inputs go to the parameters' device."""
    embed = params["embed"]
    x = _embed_rows(embed, batch["tokens"])
    if cfg.frontend == "vision_patches":
        patches = torch.as_tensor(batch["patches"], device=embed.device)
        x = torch.cat([patches.to(x.dtype), x], dim=1)    # precomputed stub
    return x


def _head(params, cfg, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(params, cfg, batch, *, remat: bool = False,
            engine: Optional[str] = None):
    """Full-sequence forward -> (logits (B, S_total, V), aux)."""
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    aux = torch.zeros((), dtype=_F32, device=x.device)
    per_sub = remat and cfg.remat_policy == "save_block_io"
    for bp, w in zip(params["layers"], _windows(cfg)):
        if remat and not per_sub:
            x, a = _recompute(_block_fwd, bp, x, cfg, w, positions, engine)
        else:
            x, a = _block_fwd(bp, x, cfg, w, positions, engine,
                              _recompute if per_sub else _call)
        aux = aux + a
    x = L.rms_norm(_stream(x), params["final_norm"], cfg.rms_eps)
    return _head(params, cfg, x), aux


class _VocabCE(torch.autograd.Function):
    """Each token's ``logz - gold`` from one model rank's vocab slice of
    the float32 logits (B, S, V_l), whose first id is ``first``: the row
    max, the sum of exponentials and the gold logit reduced over the
    model axis (``group``, None on one rank), the gold one by the
    reference's masked sum.  The backward is local and takes autograd's
    steps on the plain form in its order (log, sum, exp; the gold term's
    negated gradient at the target), so one rank gives the same bits."""

    @staticmethod
    def forward(ctx, lf, targets, first, group):

        def reduce(t, op):
            if group is None:
                return t
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))
        m = reduce(lf.amax(dim=-1, keepdim=True), "max")
        z = torch.exp(lf - m)
        sumexp = reduce(torch.sum(z, dim=-1), "sum")
        logz = torch.log(sumexp) + m[..., 0]
        vocab = first + torch.arange(lf.shape[-1], device=lf.device)
        hit = targets[..., None] == vocab
        gold = reduce(torch.where(hit, lf, 0.0).sum(dim=-1), "sum")
        ctx.save_for_backward(z, sumexp, hit)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        z, sumexp, hit = ctx.saved_tensors
        d_logz = (g / sumexp)[..., None] * z
        d_gold = torch.where(hit, -g[..., None], 0.0)
        return d_logz + d_gold, None, None, None


def _vocab_parallel_ce(lf, targets):
    """``logz - gold`` per token of DTensor logits under ``local_map``: the
    vocab axis stays sharded over the model axis (a Megatron vocab-parallel
    cross-entropy: three (B, S) all-reduces forward, none backward)."""
    am = L.abstract_mesh()
    dp = L.dp_axes()
    dp = dp if dp and _div(lf.shape[0], am, dp) else None
    split = _div(lf.shape[-1], am, "model") and model_shards(am) > 1
    lpl = to_placements(P(dp, None, "model" if split else None), am)
    rows = to_placements(P(dp, None), am)
    first = am.get_local_rank("model") * (lf.shape[-1] // model_shards(am)) \
        if split else 0
    group = am.get_group("model") if split else None
    return local_map(
        lambda lf_l, t_l: _VocabCE.apply(lf_l, t_l, first, group),
        out_placements=(rows,), in_placements=(lpl, rows),
        in_grad_placements=(lpl, rows), device_mesh=am,
        redistribute_inputs=True)(lf, targets)


def loss_fn(params, cfg, batch, *, remat: bool = True,
            engine: Optional[str] = None):
    """Next-token cross-entropy; for vlm the patch positions are excluded.
    The row max is a constant to the gradient (the reference's
    ``stop_gradient``)."""
    logits, aux = forward(params, cfg, batch, remat=remat, engine=engine)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    n_prefix = logits.shape[1] - tokens.shape[1]           # vlm patch positions
    lf = logits[:, n_prefix:, :][:, :-1, :].to(_F32)
    targets = tokens[:, 1:].long()
    if isinstance(lf, DTensor):
        ce = torch.mean(_vocab_parallel_ce(lf, targets))
    else:
        m = lf.amax(dim=-1, keepdim=True).detach()
        logz = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        gold = torch.gather(lf, -1, targets[..., None])[..., 0]
        ce = torch.mean(logz - gold)
    return ce + 0.01 * aux / cfg.n_layers, {"ce": ce, "aux": aux}


# ----------------------------- decode cache ---------------------------------

class DecodeCache(NamedTuple):
    kv_k: Optional[Tuple[torch.Tensor, ...]]       # L × (B, T, KV, hd)
    kv_v: Optional[Tuple[torch.Tensor, ...]]
    ssm_state: Optional[Tuple[torch.Tensor, ...]]  # L × (B, H, P, N) f32
    ssm_conv: Optional[Tuple[torch.Tensor, ...]]   # L × (B, K-1, conv_dim)
    length: int                                    # tokens already in cache


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> DecodeCache:
    """An empty cache on ``device`` (the GPU unless the caller says
    otherwise; without one this raises)."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    n = cfg.n_layers
    zeros = lambda shp, dt: tuple(torch.zeros(shp, dtype=dt, device=dev)  # noqa: E731
                                  for _ in range(n))
    kv_k = kv_v = ssm_state = ssm_conv = None
    if cfg.has_attention:
        shp = (batch, max_len, cfg.n_kv_padded, cfg.head_dim)
        kv_k, kv_v = zeros(shp, dtype), zeros(shp, dtype)
    if cfg.has_ssm:
        ssm_state = zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), _F32)
        ssm_conv = zeros((batch, SSM.CONV_K - 1, SSM.conv_dim(cfg)), dtype)
    return DecodeCache(kv_k, kv_v, ssm_state, ssm_conv, 0)


# ----------------------------- prefill --------------------------------------

def _block_prefill(bp, x, cfg, window, positions):
    """Like _block_fwd but collects the per-layer decode cache."""
    kv = ssm_c = None
    bp = L.gather_data_shards(bp)
    x = _stream(x)
    if cfg.family in _ATTN_FAMILIES:
        h, kv = L.attention(bp["attn"], L.rms_norm(x, bp["attn_norm"],
                                                   cfg.rms_eps),
                            cfg, positions=positions, window=window)
        x = _stream(x + h)
        y = L.rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
        if cfg.is_moe:
            m, _ = MOE.moe_layer(bp["moe"], y, cfg, groups=cfg_groups(cfg))
            x = _stream(x + m)
        else:
            x = _stream(x + L.mlp(bp["mlp"], y))
    elif cfg.family == "ssm":
        h, ssm_c = SSM.ssm_forward(bp["ssm"], L.rms_norm(x, bp["norm"],
                                                         cfg.rms_eps),
                                   cfg, return_cache=True)
        x = _stream(x + h)
    elif cfg.family == "hybrid":
        y = L.rms_norm(x, bp["in_norm"], cfg.rms_eps)
        a, kv = L.attention(bp["attn"], y, cfg, positions=positions,
                            window=window)
        s, ssm_c = SSM.ssm_forward(bp["ssm"], y, cfg, return_cache=True)
        x = _stream(x + (bp["b_attn"] * a.to(_F32)
                         + bp["b_ssm"] * s.to(_F32)).to(x.dtype))
        x = _stream(x + L.mlp(bp["mlp"], L.rms_norm(x, bp["ffn_norm"],
                                                    cfg.rms_eps)))
    return _seq_shard(x, cfg), kv, ssm_c


def prefill(params, cfg, batch, *, max_len: int = 0):
    """Process the prompt; return (last-token logits (B,1,V), DecodeCache).

    ``max_len`` reserves cache slots beyond the prompt (0 = exactly prompt).
    """
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    pad = max(max_len, s) - s
    kvs, ssms = [], []
    for bp, w in zip(params["layers"], _windows(cfg)):
        x, kv, ssm_c = _block_prefill(bp, x, cfg, w, positions)
        kvs.append(kv)
        ssms.append(ssm_c)
    x = L.rms_norm(_stream(x)[:, -1:, :], params["final_norm"], cfg.rms_eps)
    logits = _head(params, cfg, x)

    kv_k = kv_v = ssm_state = ssm_conv = None
    if cfg.has_attention:
        # (no pad when the cache is exactly the prompt: a zero pad of a
        # DTensor trips an older DTensor's redistribution planner)
        grow = lambda t: torch.nn.functional.pad(  # noqa: E731
            t, (0, 0, 0, 0, 0, pad)) if pad else t
        kv_k = tuple(grow(k) for k, _ in kvs)
        kv_v = tuple(grow(v) for _, v in kvs)
    if cfg.has_ssm:
        ssm_state = tuple(c.state for c in ssms)
        ssm_conv = tuple(c.conv for c in ssms)
    return logits, DecodeCache(kv_k, kv_v, ssm_state, ssm_conv, s)


# ----------------------------- decode ---------------------------------------

def _block_decode(bp, x, cfg, window, cache_sl, length, engine):
    """One layer, one token. cache_sl: this layer's cache tensors."""
    kv_k, kv_v, s_state, s_conv = cache_sl
    bp = L.gather_data_shards(bp)
    positions = torch.full((x.shape[0], 1), length, dtype=torch.int32,
                           device=x.device)
    if cfg.family in _ATTN_FAMILIES:
        h, (nk, nv) = L.attention(bp["attn"],
                                  L.rms_norm(x, bp["attn_norm"], cfg.rms_eps),
                                  cfg, positions=positions,
                                  kv_cache=(kv_k, kv_v), cache_len=length,
                                  window=window)
        x = _stream(x + h)
        y = L.rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
        if cfg.is_moe:
            m, _ = MOE.moe_layer(bp["moe"], y, cfg, groups=cfg_groups(cfg),
                                 engine=engine)
            x = _stream(x + m)
        else:
            x = _stream(x + L.mlp(bp["mlp"], y))
        return x, (nk, nv, s_state, s_conv)
    if cfg.family == "ssm":
        h, nc = SSM.ssm_decode_step(bp["ssm"],
                                    L.rms_norm(x, bp["norm"], cfg.rms_eps),
                                    SSM.SSMCache(s_state, s_conv), cfg)
        return _stream(x + h), (kv_k, kv_v, nc.state, nc.conv)
    if cfg.family == "hybrid":
        y = L.rms_norm(x, bp["in_norm"], cfg.rms_eps)
        a, (nk, nv) = L.attention(bp["attn"], y, cfg, positions=positions,
                                  kv_cache=(kv_k, kv_v), cache_len=length,
                                  window=window)
        s, nc = SSM.ssm_decode_step(bp["ssm"], y,
                                    SSM.SSMCache(s_state, s_conv), cfg)
        x = _stream(x + (bp["b_attn"] * a.to(_F32)
                         + bp["b_ssm"] * s.to(_F32)).to(x.dtype))
        x = _stream(x + L.mlp(bp["mlp"], L.rms_norm(x, bp["ffn_norm"],
                                                    cfg.rms_eps)))
        return x, (nk, nv, nc.state, nc.conv)
    raise ValueError(cfg.family)


def decode_step(params, cfg, token, cache: DecodeCache, *,
                engine: Optional[str] = None):
    """token: (B, 1) int -> (logits (B, 1, V), updated cache).  The given
    cache is left as it was."""
    x = _embed_rows(params["embed"], token)
    n = cfg.n_layers
    fields = [cache.kv_k, cache.kv_v, cache.ssm_state, cache.ssm_conv]
    per_layer = [f if f is not None else (None,) * n for f in fields]
    new = [[] for _ in fields]
    for i, (bp, w) in enumerate(zip(params["layers"], _windows(cfg))):
        x, sl = _block_decode(bp, x, cfg, w, [f[i] for f in per_layer],
                              cache.length, engine)
        for acc, t in zip(new, sl):
            acc.append(t)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _head(params, cfg, x)
    out = [tuple(acc) if f is not None else None
           for acc, f in zip(new, fields)]
    return logits, DecodeCache(*out, length=cache.length + 1)
