"""The port's MoE layer against the reference's: routing, the grouped
capacity dispatch, the layer, and sort against dense dispatch.

* ``_route``: the expert ids equal the reference's ``jax.lax.top_k`` order
  (lower id first among equal probabilities), with ties built in.
* Each group's ``capacity_dispatch`` tables (``gather_idx``,
  ``slot_valid``, ``position``, ``kept``, ``counts``) are byte-equal to the
  reference's ``vmap``-ed dispatch, at ``engine="argsort"`` and at
  ``engine="kernel"`` (the kernels' plain versions on the CPU).
* ``moe_layer`` agrees with the reference within ``ATOL`` at capacity
  factors 0.1 (tokens dropped) and 16, with 1 and 4 dispatch groups; both
  engines give the same bits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.core import segmented as jseg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.interop import to_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = 2e-5
KEY = jax.random.PRNGKey(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _cfgs(arch="qwen3_moe_30b_a3b", **kw):
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jcfg.get_smoke_config(arch), **kw))


def test_route_breaks_ties_like_top_k():
    """Probabilities [.5, .5, .1, .5]-shaped: equal router columns give
    exactly equal probabilities; the lower ids come first."""
    rng = np.random.default_rng(0)
    d, e = 16, 8
    router = rng.standard_normal((d, e)).astype(np.float32)
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 0]
    router[:, 6] = router[:, 5]
    x = rng.standard_normal((64, d)).astype(np.float32)
    x[:8] = 0                                  # every probability equal
    for k in (1, 2, 3, 5, 8):
        w, ids, aux = moe._route(_t(x), _t(router), k)
        jw, jids, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
        assert _same(ids, jids), k
        assert np.max(np.abs(w.numpy() - np.asarray(jw))) < 1e-6
        assert abs(float(aux) - float(jaux)) < 1e-5
    _, ids, _ = moe._route(torch.zeros(1, d), _t(router), 4)
    assert ids.tolist() == [[0, 1, 2, 3]]


def test_route_matches_reference_on_random_tokens():
    cfg, jc = _cfgs()
    p = jmoe.init_moe(KEY, jc, jnp.float32)
    x = np.random.default_rng(1).standard_normal(
        (96, cfg.d_model)).astype(np.float32)
    w, ids, aux = moe._route(_t(x), _t(p["router"]), cfg.top_k)
    jw, jids, jaux = jmoe._route(jnp.asarray(x), p["router"], cfg.top_k)
    assert _same(ids, jids)
    assert np.max(np.abs(w.numpy() - np.asarray(jw))) < 1e-6
    assert abs(float(aux) - float(jaux)) < 1e-5


@pytest.mark.parametrize("engine", ["argsort", "kernel"])
@pytest.mark.parametrize("experts,top_k,tokens,groups,cf", [
    (8, 2, 32, 1, 1.25), (8, 2, 32, 4, 0.1), (8, 2, 32, 4, 16.0),
    (128, 8, 8, 1, 1.25), (384, 8, 24, 2, 1.25), (16, 4, 40, 5, 0.5)])
def test_dispatch_tables_equal_reference(engine, experts, top_k, tokens,
                                         groups, cf):
    """Per group, the port's tables byte-equal the reference's vmap-ed
    ``capacity_dispatch`` (its argsort engine); 128 experts top-8 over 8
    tokens is a decode step of Qwen3-30B-A3B at batch 8 (capacity 4)."""
    rng = np.random.default_rng(experts + groups)
    probs = rng.random((tokens, experts)).astype(np.float32)
    ids = np.argsort(-probs, axis=1, kind="stable")[:, :top_k].astype(
        np.int32)
    tg = tokens // groups
    cap = min(max(4, int(cf * tg * top_k / experts)), tg * top_k)
    flat = ids.reshape(groups, tg * top_k)
    want = jax.vmap(lambda i: jseg.capacity_dispatch(
        i, experts, cap, engine="argsort"))(jnp.asarray(flat))
    got = moe._dispatch_tables(_t(flat), experts, cap, engine=engine)
    for name, g in zip(("gather_idx", "slot_valid", "position", "kept"),
                       got):
        assert _same(g, getattr(want, name)), name


@pytest.mark.parametrize("engine", ["argsort", "kernel"])
@pytest.mark.parametrize("cf,groups", [(0.1, 1), (0.1, 4), (16.0, 1),
                                       (16.0, 4)])
def test_moe_layer_matches_reference(cf, groups, engine):
    cfg, jc = _cfgs(capacity_factor=cf)
    p = jmoe.init_moe(KEY, jc, jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_layer(p, jnp.asarray(x), jc, groups=groups)
    got, aux = moe.moe_layer(tp, _t(x), cfg, groups=groups, engine=engine)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= ATOL
    assert abs(float(aux) - float(jaux)) <= 1e-5
    other = moe.moe_layer(tp, _t(x), cfg, groups=groups,
                          engine="argsort" if engine == "kernel"
                          else "kernel")[0]
    assert torch.equal(got, other)       # same tables, same bits


def test_moe_layer_uneven_groups_fall_back_to_one():
    """``g = groups if t % groups == 0 else 1``, as the reference."""
    cfg, jc = _cfgs()
    p = jmoe.init_moe(KEY, jc, jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(5).standard_normal(
        (1, 7, cfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_layer(p, jnp.asarray(x), jc, groups=4)
    got, _ = moe.moe_layer(tp, _t(x), cfg, groups=4)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= ATOL
    assert torch.equal(got, moe.moe_layer(tp, _t(x), cfg, groups=1)[0])


@pytest.mark.parametrize("cf", [0.1, 1.25, 16.0])
def test_sort_dispatch_equals_dense(cf):
    cfg, jc = _cfgs(capacity_factor=cf)
    p = jmoe.init_moe(KEY, jc, jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(6).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    sort, _ = moe.moe_layer(tp, _t(x), cfg)
    dcfg = dataclasses.replace(cfg, moe_dispatch="dense")
    dense, _ = moe.moe_layer(tp, _t(x), dcfg)
    assert float((sort - dense).abs().max()) < 2e-4
    want, _ = jmoe.moe_layer(p, jnp.asarray(x),
                             dataclasses.replace(jc, moe_dispatch="dense"))
    assert np.max(np.abs(dense.numpy() - np.asarray(want))) <= ATOL


def test_analysis_contract_is_the_reference_data():
    want = dict(jmoe.ANALYSIS_CONTRACT,
                entry="repro_torch.core.segmented.capacity_dispatch")
    assert moe.ANALYSIS_CONTRACT == want
