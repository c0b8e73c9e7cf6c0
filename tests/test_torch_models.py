"""The port's model zoo against the reference's, on the same parameters.

For every one of the ten architectures at its smoke config (float32), the
reference's ``init_params`` tree is carried across with
``params_from_reference``; ``forward`` (logits, aux), ``loss_fn``'s value,
``prefill`` (logits and the whole decode cache) and a run of
``decode_step``s must then agree with the reference within ``ATOL`` (the
two packages sum in different orders: XLA's contractions against
``torch.einsum``'s; observed differences are about 3e-7).  The reference's
outputs are computed once per architecture and kept for the module.

Then the counterparts of the reference's model tests (decode against
forward, sort against dense dispatch, grouped dispatch, capacity drops,
SSM chunking, window masks, the VLM frontend, prefill then decode, flash
against naive attention) run on the port alone with its own
``init_params``, at the reference's tolerances; and the smoke tests of
every architecture (a forward with its loss, a decode step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, loss_fn, params_from_reference,
                                prefill)
from repro_torch.models import layers, moe, ssm  # noqa: E402

#: logits, losses and caches against the reference (float32)
ATOL = 2e-5
#: the reference's own tolerances for its model tests
DECODE_TOL, DISPATCH_TOL, GROUP_TOL = 2e-3, 2e-4, 1e-4
B, S, PREFIX, STEPS = 2, 16, 8, 4
KEY = jax.random.PRNGKey(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, err
    return err


def _batch(cfg, rng, b, s):
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


_REF = {}


def reference_case(arch):
    """The reference's params and outputs for ``arch`` (computed once)."""
    if arch in _REF:
        return _REF[arch]
    cfg = jcfg.get_smoke_config(arch)
    params = jm.init_params(cfg, KEY)
    batch = _batch(cfg, np.random.default_rng(7), B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jm.forward(params, cfg, jb)
    loss, metrics = jm.loss_fn(params, cfg, jb)
    pre = dict(jb, tokens=jb["tokens"][:, :PREFIX])
    pl, cache = jm.prefill(params, cfg, pre, max_len=PREFIX + STEPS + 2)
    caches = [jax.tree.map(np.asarray, cache)]
    steps = []
    for t in range(PREFIX, PREFIX + STEPS):
        lg, cache = jm.decode_step(params, cfg, jb["tokens"][:, t:t + 1],
                                   cache)
        steps.append(np.asarray(lg))
    caches.append(jax.tree.map(np.asarray, cache))
    _REF[arch] = dict(
        params=jax.tree.map(np.asarray, params), batch=batch,
        logits=np.asarray(logits), aux=float(aux), loss=float(loss),
        ce=float(metrics["ce"]), prefill_logits=np.asarray(pl),
        caches=caches, steps=steps)
    return _REF[arch]


def _port(arch):
    ref = reference_case(arch)
    cfg = get_smoke_config(arch)
    return cfg, params_from_reference(cfg, ref["params"], device="cpu"), ref


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _stack(field):
    return None if field is None else torch.stack(field)


def _check_cache(got, want):
    for name in ("kv_k", "kv_v", "ssm_state", "ssm_conv"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            _close(_stack(g), w)
    assert got.length == int(want.length)


# ------------------------ against the reference ----------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, params, ref = _port(arch)
    batch = _tbatch(ref["batch"])
    logits, aux = forward(params, cfg, batch)
    _close(logits, ref["logits"])
    assert abs(float(aux) - ref["aux"]) <= ATOL
    loss, metrics = loss_fn(params, cfg, batch)
    assert abs(float(loss) - ref["loss"]) <= ATOL
    assert abs(float(metrics["ce"]) - ref["ce"]) <= ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, params, ref = _port(arch)
    batch = _tbatch(ref["batch"])
    pre = dict(batch, tokens=batch["tokens"][:, :PREFIX])
    lg, cache = prefill(params, cfg, pre, max_len=PREFIX + STEPS + 2)
    _close(lg, ref["prefill_logits"])
    _check_cache(cache, ref["caches"][0])
    for i, t in enumerate(range(PREFIX, PREFIX + STEPS)):
        lg, cache = decode_step(params, cfg, batch["tokens"][:, t:t + 1],
                                cache)
        _close(lg, ref["steps"][i])
    _check_cache(cache, ref["caches"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_shapes_and_scales(arch):
    cfg = get_smoke_config(arch)
    ref = reference_case(arch)["params"]
    got = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(got) == sorted(ref)
    assert len(got["layers"]) == cfg.n_layers

    def walk(g, r, path):
        if isinstance(r, dict):
            assert sorted(g) == sorted(r), path
            for k in r:
                walk(g[k], r[k], path + (k,))
            return
        assert tuple(g.shape) == r.shape[1:], path
        assert str(g.dtype).replace("torch.", "") == str(r.dtype), path
        scale = {"conv_w": 0.1}.get(path[-1], 0.02)
        if path[-1] in ("A_log", "dt_bias"):
            assert torch.all(g == 0), path
        elif path[-1] in ("D", "b_attn", "b_ssm") or "norm" in path[-1]:
            assert torch.all(g == (0.5 if path[-1].startswith("b_") else 1))
        elif g.numel() > 1000:
            assert abs(float(g.std()) / scale - 1) < 0.1, path

    for layer in got["layers"]:
        walk(layer, ref["layers"], ("layers",))
    for k in ref:
        if k != "layers":
            assert tuple(got[k].shape) == ref[k].shape, k
    # a seeded generator makes the draws repeatable
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], got["embed"])


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    w = rng.standard_normal(16).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    for arch in ("musicgen_medium", "phi4_mini_3_8b", "internlm2_1_8b"):
        for cfg_t, cfg_j in ((get_smoke_config(arch),
                              jcfg.get_smoke_config(arch)),
                             (jcfg.get_config(arch), jcfg.get_config(arch))):
            assert np.array_equal(layers._pad_head_mask(cfg_t).numpy(),
                                  np.asarray(jlayers._pad_head_mask(cfg_j)))


@pytest.mark.parametrize("s,cache_len", [(1, 3), (1, 9), (1, 14), (2, 9),
                                         (3, 12)])
@pytest.mark.parametrize("window", [None, 0, 4])
def test_attention_decode_matches_reference(s, cache_len, window):
    """Decode attention into a cache of 10 rows, including starts the
    reference's ``dynamic_update_slice`` clamps (cache_len past the last
    row that fits)."""
    jc = jcfg.get_smoke_config("phi4_mini_3_8b")     # padded Q heads
    cfg = get_smoke_config("phi4_mini_3_8b")
    p = jlayers.init_attention(KEY, jc, jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(cache_len)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    shp = (2, 10, cfg.n_kv_padded, cfg.head_dim)
    ck = rng.standard_normal(shp).astype(np.float32)
    cv = rng.standard_normal(shp).astype(np.float32)
    pos = np.full((2, s), cache_len, np.int32) + np.arange(s, dtype=np.int32)
    jw = None if window is None else jnp.int32(window)
    want, (wk, wv) = jlayers.attention(
        p, jnp.asarray(x), jc, positions=jnp.asarray(pos),
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.int32(cache_len), window=jw)
    got, (gk, gv) = layers.attention(tp, _t(x), cfg, positions=_t(pos),
                                     kv_cache=(_t(ck), _t(cv)),
                                     cache_len=cache_len, window=window)
    _close(got, want)
    _close(gk, wk, 1e-6)
    _close(gv, wv, 1e-6)
    assert np.array_equal(_t(ck).numpy(), ck)       # the input is untouched


def test_segsum_matches_reference_without_nan():
    x = np.random.default_rng(4).standard_normal((3, 2, 16)).astype(
        np.float32)
    got = ssm._segsum(_t(x))
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    assert np.max(np.abs(got.numpy()[fin] - want[fin])) < 1e-5
    e = torch.exp(got)
    assert not torch.isnan(e).any() and torch.all(e[..., 0, 1:] == 0)


@pytest.mark.parametrize("s,block,window", [(17, 4, None), (32, 8, None),
                                            (40, 16, 8), (64, 64, None)])
def test_flash_attention_matches_naive(s, block, window):
    """Blockwise flash == materialised softmax attention, including ragged
    tails and sliding windows; and equal to the reference's flash."""
    rng = np.random.default_rng(s)
    b, h, hd = 2, 3, 16
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(s, dtype=np.int32)[None, :]
    out_f = layers.flash_attention(_t(q), _t(k), _t(v), _t(pos), window,
                                   block)
    scores = layers._gqa_scores(_t(q), _t(k), 1) / np.sqrt(np.float32(hd))
    ii, jj = _t(pos)[:, None, :, None], _t(pos)[:, None, None, :]
    mask = jj <= ii
    if window:
        mask &= jj > ii - window
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    out_n = layers._gqa_values(probs, _t(v), 1)
    assert float((out_f - out_n).abs().max()) < 1e-5
    jw = None if window is None else jnp.int32(window)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos), jw,
                                   block)
    _close(out_f, want, 1e-5)


# ------------------- the reference's model tests, on the port ---------------

GEN = 1


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(GEN), device="cpu")


def _tokens(cfg, b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_1_3b",
                                  "hymba_1_5b", "qwen3_moe_30b_a3b"])
def test_decode_matches_forward(arch):
    cfg = get_smoke_config(arch)
    if cfg.is_moe:   # no-drop capacity so both paths keep all tokens
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = _params(cfg)
    b, s = 2, 12
    tokens = _tokens(cfg, b, s)
    logits_full, _ = forward(params, cfg, {"tokens": tokens})
    cache = init_cache(cfg, b, 32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - logits_full).abs().max())
    assert err < DECODE_TOL, (arch, err)


def test_moe_sort_equals_dense_dispatch():
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    params = _params(cfg)
    tokens = _tokens(cfg, 2, 16)
    l1, _ = forward(params, cfg, {"tokens": tokens})
    l2, _ = forward(params, dataclasses.replace(cfg, moe_dispatch="dense"),
                    {"tokens": tokens})
    assert float((l1 - l2).abs().max()) < DISPATCH_TOL


def test_moe_grouped_dispatch_invariance():
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"),
                              capacity_factor=16.0)
    params = _params(cfg)
    tokens = _tokens(cfg, 2, 16)
    l1, _ = forward(params, cfg, {"tokens": tokens})
    l2, _ = forward(params, dataclasses.replace(cfg, dispatch_groups=4),
                    {"tokens": tokens})
    assert float((l1 - l2).abs().max()) < GROUP_TOL


def test_moe_capacity_drops_tokens():
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"),
                              capacity_factor=0.1)
    moe_p = _params(cfg)["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    out, aux = moe.moe_layer(moe_p, x, cfg)
    assert torch.isfinite(out).all() and torch.isfinite(aux)
    cfg2 = dataclasses.replace(cfg, capacity_factor=16.0)
    out2, _ = moe.moe_layer(moe_p, x, cfg2)
    assert float((out - out2).abs().max()) > 1e-7


def test_ssm_chunk_invariance():
    cfg = get_smoke_config("mamba2_1_3b")
    p0 = _params(cfg)["layers"][0]["ssm"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    y1 = ssm.ssm_forward(p0, x, cfg)                              # chunk 16
    y2 = ssm.ssm_forward(p0, x, dataclasses.replace(cfg, ssm_chunk=64))
    assert float((y1 - y2).abs().max()) < 1e-3


def test_hymba_window_masks_differ():
    cfg = get_smoke_config("hymba_1_5b")          # window 8, layer 0 global
    params = _params(cfg)
    tokens = _tokens(cfg, 1, 24)
    l1, _ = forward(params, cfg, {"tokens": tokens})
    l2, _ = forward(params, dataclasses.replace(cfg, attn_window=0),
                    {"tokens": tokens})
    assert float((l1[:, :4] - l2[:, :4]).abs().max()) < 1e-4
    assert float((l1[:, -1] - l2[:, -1]).abs().max()) > 1e-6


def test_vlm_frontend_changes_output():
    cfg = get_smoke_config("internvl2_26b")
    params = _params(cfg)
    tokens = _tokens(cfg, 2, 8)
    p1 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    logits, _ = forward(params, cfg, {"tokens": tokens, "patches": p1})
    assert logits.shape[1] == cfg.num_patches + 8
    logits2, _ = forward(params, cfg, {"tokens": tokens, "patches": p1 * 2})
    assert float((logits - logits2).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_1_3b",
                                  "hymba_1_5b", "qwen3_moe_30b_a3b"])
def test_prefill_then_decode_matches_forward(arch):
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    if cfg.has_ssm:
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    params = _params(cfg)
    b, s = 2, 16
    tokens = _tokens(cfg, b, s + 4)
    lg, cache = prefill(params, cfg, {"tokens": tokens[:, :s]},
                        max_len=s + 8)
    full, _ = forward(params, cfg, {"tokens": tokens})
    errs = [float((lg[:, 0] - full[:, s - 1]).abs().max())]
    for t in range(4):
        lg, cache = decode_step(params, cfg, tokens[:, s + t:s + t + 1],
                                cache)
        errs.append(float((lg[:, 0] - full[:, s + t]).abs().max()))
    assert max(errs) < DECODE_TOL, (arch, errs)


# ------------------------------ smoke ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_loss(arch):
    """The value half of the reference's ``test_smoke_train_step``: a
    finite loss from a forward at (2, 32)."""
    cfg = get_smoke_config(arch)
    params = _params(cfg)
    batch = {"tokens": _tokens(cfg, 2, 32)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.randn(2, cfg.num_patches, cfg.d_model,
                                       generator=torch.Generator()
                                       .manual_seed(0))
    logits, aux = forward(params, cfg, batch)
    assert logits.shape == (2, 32 + cfg.num_patches, cfg.padded_vocab)
    loss, metrics = loss_fn(params, cfg, batch)
    assert np.isfinite(float(loss)) and np.isfinite(float(metrics["aux"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_smoke_config(arch)
    params = _params(cfg)
    b = 2
    cache = init_cache(cfg, b, 16, device="cpu")
    tok = _tokens(cfg, b, 1)
    logits, new = decode_step(params, cfg, tok, cache)
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all(), arch
    assert new.length == 1 and cache.length == 0
    # the step is functional: the cache it was given is unchanged
    for f in ("kv_k", "ssm_state"):
        if getattr(cache, f) is not None:
            assert all(torch.all(t == 0) for t in getattr(cache, f))
            assert any(torch.any(t != 0) for t in getattr(new, f))


def test_entry_points_go_to_the_gpu_or_raise():
    cfg = get_smoke_config("internlm2_1_8b")
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
        assert init_cache(cfg, 1, 4).kv_k[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_reference(cfg, reference_case(
                "internlm2_1_8b")["params"])
