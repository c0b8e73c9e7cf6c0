"""The port's optimizers against the reference's, on the same inputs.

Both packages get the same parameters and **the same gradients** (numpy
from a seed), so a difference is the optimizer's own: AdamW's first
steps are close to ``lr·sign(g)``, and a gradient that differed by noise
could flip a sign.  The gradients themselves are held to ``jax.grad`` in
``test_torch_train.py``.

Tolerances: parameters and float32 states within ``REL`` = 1e-6 of the
leaf's largest magnitude (the two packages round ``pow``, ``sqrt``,
``rsqrt`` and their reductions differently by an ulp or so); AdamW8bit's
int8 states byte-equal, any value off by one counted and bounded; the
int8 compressor's ``q`` byte-equal and its scales equal.  Then the
counterparts of the reference's optimizer tests
(``tests/test_substrate.py``) on the port alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as jo  # noqa: E402
from repro_torch import optim as to  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

REL = 1e-6
STEPS, LR = 4, 1e-2
#: every rank the models have: 3-D experts, matrices, vectors, 0-d scalars
SHAPES = {"experts": (3, 8, 20), "w": (8, 16), "norm": (16,),
          "odd": (300,), "scalar": ()}
NAMES = ("adamw", "adafactor", "adamw8bit")


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.size:
        err = float(np.max(np.abs(got - want)))
        assert err <= REL * max(float(np.max(np.abs(want))), 1e-30), \
            (what, err)


_CASES = {}


def trajectory(name):
    """Both packages' params and states over ``STEPS`` updates of the same
    params and gradients (the reference's computed once per optimizer)."""
    if name in _CASES:
        return _CASES[name]
    rng = np.random.default_rng(NAMES.index(name))
    p0 = _tree(rng)
    grads = [_tree(rng, 10.0 ** -i) for i in range(STEPS)]
    oj, ot = jo.get_optimizer(name), to.get_optimizer(name)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = _t(p0)
    sj, st = oj.init(pj), ot.init(pt)
    out = []
    for g in grads:
        pj, sj = oj.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj,
                           LR)
        pt, st = ot.update(_t(g), st, pt, torch.tensor(LR))
        out.append(({k: np.asarray(v) for k, v in pj.items()}, sj,
                    {k: v.clone() for k, v in pt.items()},
                    {k: (v.clone() if isinstance(v, torch.Tensor) else
                         {kk: {n: x.clone() for n, x in vv.items()}
                          if isinstance(vv, dict) else vv.clone()
                          for kk, vv in v.items()})
                     for k, v in st.items()}))
    _CASES[name] = out
    return out


@pytest.mark.parametrize("name", NAMES)
def test_params_match_reference_on_same_grads(name):
    for i, (pj, _, pt, _) in enumerate(trajectory(name)):
        for k in SHAPES:
            _close(pt[k], pj[k], f"{name} step {i} {k}")


def test_adamw_states_match_reference():
    for i, (_, sj, _, st) in enumerate(trajectory("adamw")):
        assert int(st["count"]) == int(sj["count"]) == i + 1
        for k in SHAPES:
            _close(st["m"][k], sj["m"][k], f"m {k}")
            _close(st["v"][k], sj["v"][k], f"v {k}")


def test_adafactor_states_match_reference():
    """Two or more dims factor into ``vr`` / ``vc`` (the (3, 8, 20) leaf
    into (3, 8) and (3, 20)); vectors and 0-d leaves keep a dense ``v``."""
    for _, sj, _, st in trajectory("adafactor"):
        assert int(st["count"]) == int(sj["count"])
        for k in SHAPES:
            assert sorted(st["s"][k]) == sorted(sj["s"][k]), k
            for n in st["s"][k]:
                _close(st["s"][k][n], sj["s"][k][n], f"{k}.{n}")
    last = trajectory("adafactor")[-1][3]["s"]
    assert last["experts"]["vr"].shape == (3, 8)
    assert last["experts"]["vc"].shape == (3, 20)
    assert last["scalar"]["v"].shape == ()


def test_adamw8bit_states_match_reference():
    """int8 blocks byte-equal to the reference's; a value off by one (a
    rounding tie decided by an ulp of m or v) is counted and bounded."""
    off = total = 0
    for _, sj, _, st in trajectory("adamw8bit"):
        for k in SHAPES:
            for q in ("mq", "vq"):
                got = st["s"][k][q].numpy().astype(np.int64)
                want = np.asarray(sj["s"][k][q]).astype(np.int64)
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= 1, (k, q)
                off += int((got != want).sum())
                total += got.size
            for sc in ("ms", "vs"):
                _close(st["s"][k][sc], sj["s"][k][sc], f"{k}.{sc}")
    print(f"adamw8bit int8 states off by one: {off} of {total}")
    assert off <= total // 1000, off


def test_quant_round_trip_matches_reference(rng):
    """``_quant`` pads blocks of 256 with zeros and rounds half to even."""
    x = rng.standard_normal(1000).astype(np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 0, 127, -127]     # exact ties
    qj, sj = jo.optimizers._quant(jnp.asarray(x))
    qt, st = topt._quant(torch.from_numpy(x))
    assert qt.numpy().tobytes() == np.asarray(qj).tobytes()
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    back = topt._dequant(qt, st, x.shape)
    want = jo.optimizers._dequant(qj, sj, x.shape)
    assert back.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_matches_reference(rng, max_norm):
    """The norm sums float32 squares over the leaves in sorted-key order;
    each leaf is scaled in its own dtype (a bfloat16 leaf in bfloat16)."""
    g = _tree(rng)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gj["bf"] = jnp.asarray(g["w"]).astype(jnp.bfloat16)
    gt = _t(g)
    gt["bf"] = gt["w"].to(torch.bfloat16)
    cj, nj = jo.clip_by_global_norm(gj, max_norm)
    ct, nt = to.clip_by_global_norm(gt, max_norm)
    _close(nt, nj, "norm")
    for k in SHAPES:
        _close(ct[k], cj[k], k)
    assert ct["bf"].dtype == torch.bfloat16
    bits = ct["bf"].view(torch.int16).numpy()
    want = np.asarray(cj["bf"]).view(np.int16)
    assert np.abs(bits.astype(np.int64) - want).max() <= 1


def test_clip_scales_in_place(rng):
    g = _t(_tree(rng))
    before = {k: v.clone() for k, v in g.items()}
    out, norm = to.clip_by_global_norm(g, 1e-3)
    assert all(out[k] is g[k] for k in g)
    assert float(norm) > 1e-3
    assert not torch.equal(g["w"], before["w"])


def test_schedule_matches_reference():
    """Linear warm-up from lr 0 at step 0, then cosine, clamped past
    ``total``; an int step and a tensor step give the same value."""
    lj, lt = jo.cosine_schedule(3e-4, 100, 1000), to.cosine_schedule(
        3e-4, 100, 1000)
    for s in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 5000):
        want = np.float32(lj(s))
        assert np.float32(lt(s)).tobytes() == want.tobytes(), s
        assert np.float32(lt(torch.tensor(s, dtype=torch.int32))) == want
    assert float(lt(0)) == 0.0


def test_int8_compress_matches_reference(rng):
    """Blocks of 512: ``q`` byte-equal, the scales equal, and the round
    trip equal to the reference's."""
    for n in (1000, 512, 3):
        x = rng.standard_normal((n,)).astype(np.float32)
        qj, sj = jo.int8_compress(jnp.asarray(x))
        qt, st = to.int8_compress(torch.from_numpy(x))
        assert qt.numpy().tobytes() == np.asarray(qj).tobytes()
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        back = to.int8_decompress(qt, st, x.shape)
        want = jo.int8_decompress(qj, sj, x.shape)
        assert back.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_update_writes_in_place(name):
    """The update overwrites and returns the given tensors."""
    p = _t(_tree(np.random.default_rng(1)))
    g = _t(_tree(np.random.default_rng(2)))
    opt = to.get_optimizer(name)
    state = opt.init(p)
    before = {k: v.clone() for k, v in p.items()}
    out, new_state = opt.update(g, state, p, 1e-2)
    assert new_state is state and int(state["count"]) == 1
    assert all(out[k] is p[k] for k in p)
    assert not torch.equal(p["w"], before["w"])


# ---- counterparts of the reference's optimizer tests ----------------------

def _toy():
    params = {"w": torch.ones((8, 16)), "b": torch.zeros((16,))}
    grads = {"w": torch.full((8, 16), 0.5), "b": torch.full((16,), -0.25)}
    return params, grads


@pytest.mark.parametrize("maker", [to.adamw, to.adafactor, to.adamw8bit])
def test_optimizers_descend(maker):
    params, grads = _toy()
    opt = maker()
    state = opt.init(params)
    w0, b0 = float(params["w"].mean()), float(params["b"].mean())
    p1, state = opt.update({k: v.clone() for k, v in grads.items()}, state,
                           params, 1e-2)
    assert float(p1["w"].mean()) < w0
    assert float(p1["b"].mean()) > b0
    p2, state = opt.update(grads, state, p1, 1e-2)
    assert all(torch.isfinite(x).all() for x in p2.values())


def test_adam8bit_tracks_adamw():
    (pa, grads), (pb, _) = _toy(), _toy()
    oa, ob = to.adamw(weight_decay=0.0), to.adamw8bit(weight_decay=0.0)
    sa, sb = oa.init(pa), ob.init(pb)
    for _ in range(5):
        pa, sa = oa.update(grads, sa, pa, 1e-2)
        pb, sb = ob.update(grads, sb, pb, 1e-2)
    err = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    assert err < 5e-3, err


def test_adafactor_state_is_small():
    st = to.adafactor().init({"w": torch.ones((256, 512))})
    elems = sum(x.numel() for x in st["s"]["w"].values())
    assert elems <= 256 + 512


def test_clip_and_schedule():
    _, grads = _toy()
    clipped, gn = to.clip_by_global_norm(grads, 1e-3)
    cn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in clipped.values()))
    assert float(cn) <= 1.1e-3
    lr = to.cosine_schedule(1e-3, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-5


def test_int8_compression_roundtrip(rng):
    x = torch.from_numpy(rng.standard_normal((1000,)).astype(np.float32))
    q, s = to.int8_compress(x)
    back = to.int8_decompress(q, s, x.shape)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 100
