"""The port's length bucketing (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``), route by route, on the CPU: the
host LSD route, the out-of-core route (with spill, fault, retry and
checkpoint pass-through) and the distributed route over ``LocalMesh(1)``
and ``LocalMesh(4)`` (the reference's P = 4 in a fresh interpreter with
fake host devices, ``tests/_multidev.py``).  ``order`` and ``bounds`` must
be equal to the reference's for the same route, and so must its argument
errors."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from _multidev import run_multidev  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.distributed import LocalMesh  # noqa: E402
from repro_torch.data import length_bucketed_batches  # noqa: E402

BATCH = 4096


def _lengths(kind, n=1203):
    """Document lengths from a seed: typical (< 2^9), long (16-bit: two
    passes), huge (three and four occupied bytes, with 0 and
    0xFFFFFFFF), or all equal."""
    rng = np.random.default_rng(41)
    if kind == "typical":
        return rng.integers(1, 512, n)
    if kind == "long":
        return rng.integers(0, 1 << 16, n).astype(np.uint32)
    if kind == "huge":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        x[:3] = [0, 0xFFFFFFFF, 0xFFFFFFFF]
        x[3:200] >>= 9
        return x
    return np.full(n, 300, np.uint32)


def _equal(got, want):
    order, bounds = got
    assert isinstance(order, np.ndarray)
    assert order.dtype == np.asarray(want[0]).dtype
    assert np.array_equal(order, np.asarray(want[0]))
    assert bounds == want[1]


@pytest.mark.parametrize("engine", [None, "kernel"])
@pytest.mark.parametrize("kind", ["typical", "long", "huge", "equal"])
def test_host_route_equals_reference(kind, engine):
    x = _lengths(kind)
    want = jpipe.length_bucketed_batches(x, BATCH, engine="argsort")
    got = length_bucketed_batches(x, BATCH, engine=engine, device="cpu")
    _equal(got, want)


def test_host_route_empty_and_tiny_batches():
    empty = np.zeros(0, np.uint32)
    _equal(length_bucketed_batches(empty, BATCH, device="cpu"),
           jpipe.length_bucketed_batches(empty, BATCH, engine="argsort"))
    x = _lengths("typical", 50)
    _equal(length_bucketed_batches(x, 1, device="cpu"),
           jpipe.length_bucketed_batches(x, 1, engine="argsort"))


@pytest.mark.parametrize("opts", [
    dict(ooc_chunk_elems=128),
    dict(ooc_chunk_elems=300),
    dict(ooc_chunk_elems=128, ooc_spill_budget_bytes=64 * 1024),
    dict(ooc_chunk_elems=128, ooc_device_slab_elems=256),
], ids=["chunks128", "chunks300", "spill", "slab"])
@pytest.mark.parametrize("kind", ["typical", "huge"])
def test_ooc_route_equals_reference(kind, opts):
    x = _lengths(kind, 700)
    want = jpipe.length_bucketed_batches(x, BATCH, engine="argsort", **opts)
    got = length_bucketed_batches(x, BATCH, device="cpu", **opts)
    _equal(got, want)


def test_ooc_route_faults_retry_checkpoint(tmp_path):
    """The resilience options pass through: the same fault schedule, the
    same order and bounds, the same policy state after the run, and a
    checkpoint written by each package."""
    x = _lengths("long", 900)
    kw = dict(seed=3, rates={"chunk_upload": 0.3, "merge_launch": 0.3})
    jpol, tpol = jfaults.FaultPolicy(**kw), tfaults.FaultPolicy(**kw)
    jret = jfaults.RetryPolicy(max_retries=6)
    tret = tfaults.RetryPolicy(max_retries=6)
    opts = dict(ooc_chunk_elems=128, ooc_spill_budget_bytes=64 * 1024)
    want = jpipe.length_bucketed_batches(
        x, BATCH, engine="argsort", ooc_fault_policy=jpol,
        ooc_retry_policy=jret, ooc_checkpoint_dir=str(tmp_path / "j"),
        **opts)
    got = length_bucketed_batches(
        x, BATCH, ooc_fault_policy=tpol, ooc_retry_policy=tret,
        ooc_checkpoint_dir=str(tmp_path / "t"), device="cpu", **opts)
    _equal(got, want)
    assert tpol.state() == jpol.state()
    assert os.listdir(tmp_path / "t")


def test_argument_errors_equal_reference():
    x = _lengths("typical", 64)
    bad = [dict(ooc_spill_budget_bytes=1024), dict(ooc_device_slab_elems=8),
           dict(ooc_fault_policy="p"), dict(ooc_retry_policy="r"),
           dict(ooc_checkpoint_dir="d")]
    for kw in bad:
        with pytest.raises(ValueError, match="ooc_chunk_elems") as jerr:
            jpipe.length_bucketed_batches(x, BATCH, **kw)
        with pytest.raises(ValueError, match="ooc_chunk_elems") as terr:
            length_bucketed_batches(x, BATCH, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="exclusive") as jerr:
        jpipe.length_bucketed_batches(
            x, BATCH, dist_mesh=jax.make_mesh((1,), ("data",)),
            ooc_chunk_elems=64)
    with pytest.raises(ValueError, match="exclusive") as terr:
        length_bucketed_batches(x, BATCH, dist_mesh=LocalMesh(1, "cpu"),
                                ooc_chunk_elems=64)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------------------
# the distributed route
# --------------------------------------------------------------------------

#: doc counts that need sentinel padding at P = 4 (and one that does not),
#: the second past the tiny-shard slack's threshold
DIST_CASES = [("typical", 1203), ("long", 4 * 1100 + 3), ("huge", 4001),
              ("equal", 800)]

DIST_BODY = """
from repro.data.pipeline import length_bucketed_batches
inp = np.load({inputs!r})
out = {{}}
for name in inp.files:
    order, bounds = length_bucketed_batches(inp[name], {batch},
                                            engine="argsort",
                                            dist_mesh=mesh)
    out[name + "/order"] = order
    out[name + "/bounds"] = np.asarray(bounds)
np.savez({outputs!r}, **out)
"""


@pytest.fixture(scope="module")
def dist_reference(tmp_path_factory):
    """The reference's dist route at P = 4, in one subprocess."""
    tmp = tmp_path_factory.mktemp("pipeline_reference")
    inputs = {f"{k}_{n}": _lengths(k, n) for k, n in DIST_CASES}
    paths = dict(inputs=str(tmp / "in.npz"), outputs=str(tmp / "out.npz"))
    np.savez(paths["inputs"], **inputs)
    run_multidev(DIST_BODY.format(batch=BATCH, **paths), ndev=4,
                 timeout=600)
    return inputs, dict(np.load(paths["outputs"]))


@pytest.mark.parametrize("case", [f"{k}_{n}" for k, n in DIST_CASES])
def test_dist_route_four_shards_equals_reference(dist_reference, case):
    inputs, ref = dist_reference
    x = inputs[case]
    got = length_bucketed_batches(x, BATCH, dist_mesh=LocalMesh(4, "cpu"))
    _equal(got, (ref[case + "/order"], ref[case + "/bounds"].tolist()))
    host = length_bucketed_batches(x, BATCH, device="cpu")
    assert np.array_equal(x[got[0]], x[host[0]]) and got[1] == host[1]


@pytest.mark.parametrize("engine", [None, "kernel"])
@pytest.mark.parametrize("kind,n", [("typical", 203), ("huge", 1500)])
def test_dist_route_one_shard_equals_reference(kind, n, engine):
    x = _lengths(kind, n)
    want = jpipe.length_bucketed_batches(
        x, BATCH, engine="argsort", dist_mesh=jax.make_mesh((1,), ("data",)))
    got = length_bucketed_batches(x, BATCH, engine=engine,
                                  dist_mesh=LocalMesh(1, "cpu"))
    _equal(got, want)


def test_dist_route_overflow_raises(monkeypatch):
    """A residual overflow after the retries is an error, as in the
    reference: forced here by a zero-slack exchange."""
    from repro_torch.core import distributed
    real = distributed.make_distributed_sort
    monkeypatch.setattr(distributed, "make_distributed_sort",
                        lambda mesh, **kw: real(mesh, **dict(kw, slack=0.1)))
    x = _lengths("long", 4 * 1500)
    with pytest.raises(RuntimeError, match="overflowed"):
        length_bucketed_batches(x, BATCH, dist_mesh=LocalMesh(4, "cpu"))
