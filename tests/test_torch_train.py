"""The port's backward path and trainer against the reference's.

* Gradients: for every one of the ten architectures at its smoke config
  (float32), the reference's parameters cross with
  ``params_from_reference``; ``torch.autograd`` through the port's
  ``loss_fn`` (``remat`` on and off) must agree with ``jax.grad`` of the
  reference's within ``GRAD_ATOL`` = 1e-6 (observed up to 1.5e-7: the two
  packages sum in different orders), and the two remat settings must give
  the same bits.  The reference's gradients are computed once per
  architecture.
* One ``make_train_step`` step per optimizer, 1 and 4 microbatches, on
  the smoke Qwen3 (its MoE dispatch included): the loss and the gradient
  norm within 1e-5, the learning rate equal, and the parameters within
  ``STEP_ATOL`` of the reference's, except that an element whose
  gradient's sign the two packages' rounding can flip may move by up to
  two learning rates (AdamW's first step is ``lr·sign(g)``); such elements
  are counted and bounded.  Adafactor is held to the reference's
  optimizer applied to the per-layer tree: the reference's scan-stacked
  leaves make a norm an (L, d) matrix (factored) and span the RMS clip
  over all layers, which the port's per-layer leaves do not.
* The trainer: resume after a failure reaches the bits of an
  uninterrupted run, the loss falls on a tiny model, microbatches give the
  full batch's step, ``donate`` semantics, the first step's lr of 0, the
  dispatch census with ``remat``, the CLI.
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
from repro import optim as jo  # noqa: E402
from repro import train as jt  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.core.interop import tree_flatten  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.models import loss_fn, params_from_reference  # noqa: E402
from repro_torch.train import Trainer, TrainState, make_train_step  # noqa: E402

GRAD_ATOL = 1e-6
STEP_ATOL, LOSS_ATOL = 1e-6, 1e-5
B, S = 2, 32
KEY = jax.random.PRNGKey(1)
STEP_ARCH = "qwen3_moe_30b_a3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _per_layer(cfg, tree):
    """A reference tree with its stacked ``layers`` as a list of dicts."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = [jax.tree.map(lambda a, i=i: np.asarray(a)[i],
                                  tree["layers"]) for i in range(cfg.n_layers)]
    return out


_GRADS = {}


def reference_grads(arch):
    """(params, batch, loss, grads per layer) of the reference, once."""
    if arch not in _GRADS:
        cfg = jcfg.get_smoke_config(arch)
        params = jm.init_params(cfg, KEY)
        batch = _batch(cfg, np.random.default_rng(ARCHS.index(arch)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, cfg, jb), has_aux=True))(params)
        _GRADS[arch] = (_np(params), batch, float(loss),
                        _per_layer(cfg, _np(grads)))
    return _GRADS[arch]


def _port_grads(arch, remat, engine=None, policy=None):
    params, batch, _, _ = reference_grads(arch)
    cfg = get_smoke_config(arch)
    if policy:
        cfg = dataclasses.replace(cfg, remat_policy=policy)
    tp = params_from_reference(cfg, params, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                      remat=remat, engine=engine)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_grad(arch, remat):
    _, _, want_loss, want = reference_grads(arch)
    loss, got = _port_grads(arch, remat)
    assert abs(loss - want_loss) <= LOSS_ATOL
    want, _ = tree_flatten(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        assert torch.isfinite(g).all(), arch            # no NaN from _segsum
        err = float(np.max(np.abs(g.numpy() - w))) if w.size else 0.0
        assert err <= GRAD_ATOL, (arch, err)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "hymba_1_5b",
                                  "mamba2_1_3b"])
def test_remat_policies_give_the_same_bits(arch):
    """Recomputing a block (``full``) or each sub-layer
    (``save_block_io``) changes no bit of the gradients."""
    _, plain = _port_grads(arch, remat=False)
    for policy in ("full", "save_block_io"):
        _, got = _port_grads(arch, remat=True, policy=policy)
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), policy


def test_dispatch_engines_give_the_same_gradients():
    """The kernel engine (its plain versions here) and argsort build the
    same dispatch tables, and both backward passes are gathers through
    them: the gradients are bit-identical."""
    _, argsort = _port_grads(STEP_ARCH, remat=True, engine="argsort")
    _, kernel = _port_grads(STEP_ARCH, remat=True, engine="kernel")
    assert all(torch.equal(a, b) for a, b in zip(kernel, argsort))


# ---- one train step per optimizer ------------------------------------------

_STEPS = {}


def reference_step(opt, mb):
    """The reference's params, metrics and per-layer params after one step
    (warmup 0, so the step's lr is ``base_lr``)."""
    if (opt, mb) in _STEPS:
        return _STEPS[(opt, mb)]
    cfg = jcfg.get_smoke_config(STEP_ARCH)
    params = jm.init_params(cfg, KEY)
    batch = JData(vocab=cfg.vocab, seq_len=16, global_batch=4).batch(0)
    if opt == "adafactor":
        new, metrics = _adafactor_per_layer(cfg, params, batch, mb)
    else:
        o, step = jt.make_train_step(cfg, opt, warmup=0, donate=False,
                                     microbatches=mb)
        out, metrics = step(jt.TrainState(params, o.init(params),
                                          jnp.int32(0)), batch)
        new = _per_layer(cfg, _np(out.params))
    _STEPS[(opt, mb)] = (_np(params), _np(batch), new,
                         {k: float(v) for k, v in metrics.items()})
    return _STEPS[(opt, mb)]


def _adafactor_per_layer(cfg, params, batch, mb):
    """The reference's step (grads of each microbatch summed as its scan
    does, clip, schedule) with its Adafactor applied per layer."""
    sliced = jax.tree.map(lambda x: x.reshape((mb, x.shape[0] // mb)
                                              + x.shape[1:]), batch)
    grads = jax.tree.map(jnp.zeros_like, params)
    loss = jnp.float32(0.0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, cfg, b), has_aux=True))
    for i in range(mb):
        (l, _), g = grad_fn(params, jax.tree.map(lambda x: x[i], sliced))
        loss = loss + l / mb
        grads = jax.tree.map(lambda a, b: a + b / mb, grads, g)
    grads, gnorm = jo.clip_by_global_norm(grads, 1.0)
    lr = jo.cosine_schedule(3e-4, 0, 10_000)(0)
    opt = jo.adafactor()
    per = jax.tree.map(jnp.asarray, _per_layer(cfg, _np(params)))
    new, _ = opt.update(jax.tree.map(jnp.asarray, _per_layer(cfg, _np(grads))),
                        opt.init(per), per, lr)
    return _np(new), {"loss": loss, "grad_norm": gnorm, "lr": lr}


@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw8bit"])
def test_train_step_matches_reference(opt, mb):
    params, batch, want, wm = reference_step(opt, mb)
    cfg = get_smoke_config(STEP_ARCH)
    o, step = make_train_step(cfg, opt, warmup=0, donate=False,
                              microbatches=mb)
    tp = params_from_reference(cfg, params, device="cpu")
    state = TrainState(tp, o.init(tp), torch.zeros((), dtype=torch.int32))
    out, m = step(state, {k: torch.from_numpy(np.array(v))
                          for k, v in batch.items()})
    assert int(out.step) == 1
    assert abs(float(m["loss"]) - wm["loss"]) <= LOSS_ATOL
    assert abs(float(m["grad_norm"]) - wm["grad_norm"]) <= \
        LOSS_ATOL * wm["grad_norm"]
    assert np.float32(m["lr"]) == np.float32(wm["lr"])
    lr = wm["lr"]
    got, _ = tree_flatten(out.params)
    want, _ = tree_flatten(want)
    flipped = total = 0
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - w)
        assert err.max(initial=0) <= 2.2 * lr
        flipped += int((err > STEP_ATOL).sum())
        total += err.size
    print(f"{opt} x{mb}: {flipped} of {total} elements past {STEP_ATOL}")
    assert flipped <= total // 1000, flipped


# ---- the trainer -----------------------------------------------------------

def test_first_step_has_lr_zero_and_donate_semantics():
    """lr(0) = 0: step 0 leaves the weights as they were; ``donate=False``
    leaves its input state untouched, ``donate=True`` updates it in place."""
    cfg = get_smoke_config("internlm2_1_8b")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=2,
                           device="cpu")
    tp = params_from_reference(cfg, _np(jm.init_params(
        jcfg.get_smoke_config("internlm2_1_8b"), KEY)), device="cpu")
    o, keep = make_train_step(cfg, donate=False)
    state = TrainState(tp, o.init(tp), torch.zeros((), dtype=torch.int32))
    before = [t.clone() for t in tree_flatten(tp)[0]]
    s1, m1 = keep(state, data.batch(0))
    assert float(m1["lr"]) == 0.0 and float(m1["grad_norm"]) > 0
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(s1.params)[0], before))
    s2, m2 = keep(s1, data.batch(1))
    assert float(m2["lr"]) > 0
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_flatten(s2.params)[0], before))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(s1.params)[0], before))   # input untouched
    _, donate = make_train_step(cfg)
    s3, _ = donate(s2, data.batch(2))
    assert all(a is b for a, b in zip(tree_flatten(s3.params)[0],
                                      tree_flatten(s2.params)[0]))
    assert not any(t.requires_grad for t in tree_flatten(s3.params)[0])


def test_microbatched_grads_match_full():
    """m-microbatch accumulation == full-batch step (mean loss)."""
    cfg = get_smoke_config("internlm2_1_8b")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=4,
                           device="cpu")
    params = params_from_reference(cfg, _np(jm.init_params(
        jcfg.get_smoke_config("internlm2_1_8b"), KEY)), device="cpu")
    batch = data.batch(0)
    opt1, step1 = make_train_step(cfg, donate=False, warmup=0)
    opt4, step4 = make_train_step(cfg, donate=False, warmup=0,
                                  microbatches=4)
    zero = torch.zeros((), dtype=torch.int32)
    o1, m1 = step1(TrainState(params, opt1.init(params), zero), batch)
    o4, m4 = step4(TrainState(params, opt4.init(params), zero), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_flatten(o1.params)[0], tree_flatten(o4.params)[0]))
    assert err < 1e-5, err


def test_dispatch_census_with_remat(monkeypatch):
    """The kernel engine's wrappers (their plain versions here) run once
    per MoE layer and microbatch in the forward and once more in the
    backward's recompute."""
    calls = {"initial_histogram": 0, "fused_counting_pass": 0}
    for attr in calls:
        orig = getattr(fused, attr)

        def hook(*a, __orig=orig, __name=attr, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)
        monkeypatch.setattr(fused, attr, hook)
    cfg = get_smoke_config(STEP_ARCH)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=4,
                           device="cpu")
    from repro_torch.models import init_params
    for remat, per_call in ((True, 2), (False, 1)):
        c = dataclasses.replace(cfg, remat=remat)
        p = init_params(c, device="cpu")
        o, step = make_train_step(c, microbatches=2, engine="kernel")
        for k in calls:
            calls[k] = 0
        step(TrainState(p, o.init(p), torch.zeros((), dtype=torch.int32)),
             data.batch(0))
        want = per_call * c.n_layers * 2
        assert calls == {k: want for k in calls}, (remat, calls)


def test_train_resume_after_failure(tmp_path):
    """A run resumed from its step-5 checkpoint reaches the same bits at
    step 10 as a run without failure."""
    cfg = get_smoke_config("internlm2_1_8b")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=2,
                           device="cpu")
    tr = Trainer(cfg, data, str(tmp_path), ckpt_every=5, log_every=100,
                 total_steps=50, device="cpu")
    state = tr.run(tr.init_or_resume(0), 7)   # "crash" after step 7
    assert int(state.step) == 7

    tr2 = Trainer(cfg, data, str(tmp_path), ckpt_every=5, log_every=100,
                  total_steps=50, device="cpu")
    state2 = tr2.init_or_resume(0)
    assert int(state2.step) == 5              # resumed from the checkpoint
    state2 = tr2.run(state2, 5)
    assert int(state2.step) == 10

    tr3 = Trainer(cfg, data, str(tmp_path) + "_b", ckpt_every=100,
                  log_every=100, total_steps=50, device="cpu")
    state3 = tr3.run(tr3.init_or_resume(0), 10)
    a, b = tree_flatten(state2)[0], tree_flatten(state3)[0]
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_loss_decreases_on_tiny_model(tmp_path):
    cfg = get_smoke_config("internlm2_1_8b")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4,
                           device="cpu")
    tr = Trainer(cfg, data, str(tmp_path), ckpt_every=1000, log_every=1000,
                 base_lr=3e-3, total_steps=60, device="cpu")
    losses = []
    tr.run(tr.init_or_resume(0), 40,
           on_step=lambda s, st, m: losses.append(float(m["loss"])))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_launch_train_cli(tmp_path, capsys):
    from repro_torch.launch import train as launch
    state = launch.main(["--arch", "qwen3_moe_30b_a3b", "--smoke", "--steps",
                         "3", "--seq-len", "16", "--global-batch", "2",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] qwen3-moe-30b-a3b-smoke:" in out and "devices=1" in out
    assert int(state.step) == 3
    assert (tmp_path / "qwen3-moe-30b-a3b-smoke" / "step_0000000002").is_dir()
