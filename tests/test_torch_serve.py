"""The port's ``ServeEngine`` against the reference's, on the same params.

* ``schedule`` gives the same batches for the same queue, by the
  counting-partition route and by the out-of-core ``AdmissionConfig`` route;
* ``generate`` on the smoke internlm2 and qwen3 configs gives the same
  tokens as the reference, with the reference's params carried across;
* the census on the CPU's kernel engine: ``schedule`` is one histogram and
  one fused pass, and every decode step of the MoE model one of each per
  layer (wrapper calls counted with monkeypatch);
* the counterpart of the reference's ``test_serve_engine_generates``;
* without ``device=`` the engine is on the GPU, and raises without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.models import init_params, params_from_reference  # noqa: E402
from repro_torch.serve import (AdmissionConfig, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.serve import engine as teng  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _queue_spec(seed, n, vocab, new_lo=4, new_hi=300):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 10))).astype(
        np.int32), int(rng.integers(new_lo, new_hi))) for _ in range(n)]


def _queues(spec):
    return ([jeng.Request(i, p, m) for i, (p, m) in enumerate(spec)],
            [Request(i, p, m) for i, (p, m) in enumerate(spec)])


_CASES = {}


def _engines(arch, batch=3, max_len=64, **kw):
    if arch not in _CASES:
        cfg = jcfg.get_smoke_config(arch)
        params = jm.init_params(cfg, KEY)
        tp = params_from_reference(get_smoke_config(arch),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
        _CASES[arch] = (cfg, params, tp)
    cfg, params, tp = _CASES[arch]
    jadm = kw.pop("jadmission", None)
    return (jeng.ServeEngine(cfg, params, batch, max_len, admission=jadm),
            ServeEngine(get_smoke_config(arch), tp, batch, max_len,
                        device="cpu", **kw))


def _rids(batches):
    return [[r.rid for r in b] for b in batches]


@pytest.mark.parametrize("seed,n,batch", [(0, 7, 3), (1, 40, 8), (2, 1, 4),
                                          (3, 300, 16)])
def test_schedule_equals_reference(seed, n, batch):
    je, te = _engines("internlm2_1_8b", batch=batch)
    jq, tq = _queues(_queue_spec(seed, n, 256, 0, 20000))
    assert _rids(te.schedule(tq)) == _rids(je.schedule(jq))
    assert te.schedule([]) == []


@pytest.mark.parametrize("chunk,budget", [(4, None), (16, None),
                                          (8, 1 << 15)])
def test_schedule_admission_route_equals_reference(chunk, budget):
    jadm = jeng.AdmissionConfig(chunk_elems=chunk, spill_budget_bytes=budget)
    adm = AdmissionConfig(chunk_elems=chunk, spill_budget_bytes=budget)
    je, te = _engines("internlm2_1_8b", batch=5, jadmission=jadm,
                      admission=adm)
    jq, tq = _queues(_queue_spec(chunk, 61, 256, 0, 1000))
    got = _rids(te.schedule(tq))
    assert got == _rids(je.schedule(jq))
    # and the same as the partition route
    _, plain = _engines("internlm2_1_8b", batch=5)
    assert got == _rids(plain.schedule(tq))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen3_moe_30b_a3b"])
def test_generate_equals_reference(arch):
    je, te = _engines(arch)
    jq, tq = _queues(_queue_spec(11, 5, 256, 4, 24))
    jb, tb = je.schedule(jq), te.schedule(tq)
    assert _rids(jb) == _rids(tb)
    for jbatch, tbatch in zip(jb, tb):
        je.generate(jbatch)
        te.generate(tbatch)
        for jr, tr in zip(jbatch, tbatch):
            assert tr.generated.dtype == np.int32
            assert np.array_equal(tr.generated, jr.generated), jr.rid


def test_census_on_the_kernel_engine(monkeypatch):
    """On the CPU the kernel engine runs the plain versions: count the
    wrapper calls.  ``schedule``: 1 + 1; each decode step of the smoke
    Qwen3 (2 layers, 1 group): 2 + 2; a generate of s prompt tokens and m
    new ones: s + m steps."""
    calls = {"histogram": 0, "fused_pass": 0}
    for name, attr in (("histogram", "initial_histogram"),
                       ("fused_pass", "fused_counting_pass")):
        orig = getattr(fused, attr)

        def hook(*a, __orig=orig, __name=name, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)
        monkeypatch.setattr(fused, attr, hook)
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), 2, 32,
                      device="cpu", dispatch_engine="kernel")
    _, q = _queues(_queue_spec(5, 3, cfg.vocab, 2, 6))
    batches = eng.schedule(q)
    assert calls == {"histogram": 1, "fused_pass": 1}
    steps = []
    orig_step = teng.decode_step

    def step(*a, **kw):
        before = dict(calls)
        out = orig_step(*a, **kw)
        steps.append({k: calls[k] - before[k] for k in calls})
        return out
    monkeypatch.setattr(teng, "decode_step", step)
    reqs = eng.generate(batches[0])
    s = max(len(r.prompt) for r in reqs)
    m = max(r.max_new_tokens for r in reqs)
    assert len(steps) == s + m
    per = cfg.n_layers * cfg.dispatch_groups
    assert all(st == {"histogram": per, "fused_pass": per} for st in steps)


def test_serve_engine_generates():
    cfg = get_smoke_config("internlm2_1_8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    queue = [Request(i, rng.integers(0, cfg.vocab, rng.integers(3, 10)),
                     max_new_tokens=int(rng.integers(4, 12)))
             for i in range(5)]
    batches = eng.schedule(queue)
    assert sum(len(b) for b in batches) == 5
    done = eng.generate(batches[0])
    for r in done:
        assert r.generated is not None and len(r.generated) == \
            r.max_new_tokens
        assert (r.generated >= 0).all() and (r.generated < cfg.vocab).all()


def test_numpy_queue_goes_to_the_gpu_or_raises():
    cfg = get_smoke_config("internlm2_1_8b")
    params = init_params(cfg, device="cpu")
    q = [Request(0, np.arange(4, dtype=np.int32), 3)]
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="parameters are on cpu"):
            ServeEngine(cfg, params, 1, 16)
        gpu = init_params(cfg)
        eng = ServeEngine(cfg, gpu, 1, 16)
        assert eng.device.type == "cuda"
        assert len(eng.generate(eng.schedule(q)[0])[0].generated) == 3
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params, 1, 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params, 1, 16, device="cuda")
    eng = ServeEngine(cfg, params, 1, 16, device="cpu")
    assert eng.schedule(q)[0][0] is q[0]
