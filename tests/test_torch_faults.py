"""Faults, retries, the ladder, checkpoints and resume: the port against ``repro``.

Under the same ``FaultPolicy`` seed both packages draw the same faults at
the same op indices, so the port must give the reference's keys, values,
``OocStats`` and fault-schedule counters exactly:

  * a transient fault at each of the seven sites (the host-corruption
    pseudo-site recovers from a round checkpoint);
  * deterministic replay under a rate-driven storm;
  * the three-rung ladder (slab, kway, re-chunk) and the device-resident
    kway rung;
  * kill-and-resume: a run killed at the fatal merge-launch indices of the
    reference's ``test_kill_and_resume_byte_identical`` resumes from the
    port's own round checkpoint to the reference's uninterrupted output;
  * the port's store: atomic publish and the sha256 refusal of a corrupted
    chunk.

The port runs on the CPU (``device="cpu"``, ``argsort`` engine); each
package writes checkpoints in its own format to its own directory.
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import faults as jfaults  # noqa: E402
from repro.core.outofcore import oocsort as j_oocsort  # noqa: E402
from repro_torch import oocsort  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402

TILE = 16
BUDGET = 4096
N = 3000
CHUNK = 700


def _data(rng, dtype=np.uint32, n=N):
    if np.dtype(dtype).kind == "f":
        keys = rng.normal(size=n).astype(dtype) * 100.0
    else:
        keys = rng.integers(0, 2 ** 32, n).astype(dtype)
    return keys, np.arange(n, dtype=np.uint32)


def _policies(**kw):
    return jfaults.FaultPolicy(**kw), tfaults.FaultPolicy(**kw)


def _retries(**kw):
    return jfaults.RetryPolicy(**kw), tfaults.RetryPolicy(**kw)


def _pair(keys, vals, jpol=None, tpol=None, jretry=None, tretry=None,
          jdir=None, tdir=None, chunk=CHUNK, **kw):
    """Reference and port on the same input and fault schedule; returns
    both results after checking bytes, stats and schedule counters."""
    kw = dict(dict(engine="argsort", tile=TILE, spill_budget_bytes=BUDGET,
                   return_stats=True), **kw)
    want = j_oocsort(keys, chunk, values=vals, faults=jpol, retry=jretry,
                     checkpoint_dir=jdir, **kw)
    got = oocsort(keys, chunk, values=vals, faults=tpol, retry=tretry,
                  checkpoint_dir=tdir, device="cpu", **kw)
    _same(got, want)
    if jpol is not None:
        assert tpol.state() == jpol.state()
    return got, want


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[-1]._asdict() == want[-1]._asdict()


# --------------------------- unit layer --------------------------------------

def test_fault_policy_draws_equal_reference():
    for kw in (dict(seed=9, rates={"slab_upload": 0.5}),
               dict(seed=3, rates={s: 0.2 for s in tfaults.FAULT_SITES},
                    fail_at={"merge_launch": [2, 3]},
                    fatal_at={"chunk_upload": [40]})):
        jp, tp = _policies(**kw)
        for site in tfaults.FAULT_SITES * 20:
            assert tp.draw(site) == jp.draw(site)
        assert tp.state() == jp.state()


def test_checksums_and_retry_policy_equal_reference():
    x = np.arange(64, dtype=np.uint32)
    for a in (x, x.view(np.int32), x.reshape(8, 8), x.astype(np.float64)):
        assert tfaults.host_checksum(a) == jfaults.host_checksum(a)
    jr, tr = _retries(max_retries=3, backoff_base_s=0.01, backoff_cap_s=0.02)
    assert [tr.backoff_s(i) for i in range(6)] == \
        [jr.backoff_s(i) for i in range(6)]
    with pytest.raises(ValueError):
        tfaults.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="unknown fault site"):
        tfaults.FaultPolicy(rates={"warp_divergence": 0.5})


def test_maybe_corrupt_flips_the_same_byte():
    jp, tp = _policies(seed=6, fail_at={"host_corruption": [0]})
    a = [np.arange(50, dtype=np.uint32), np.arange(9, dtype=np.int16)]
    b = [v.copy() for v in a]
    assert jp.maybe_corrupt(a) and tp.maybe_corrupt(b)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


# --------------------------- the seven sites ---------------------------------

@pytest.mark.parametrize("site", tfaults.FAULT_SITES)
def test_transient_fault_at_each_site(rng, site):
    keys, vals = _data(rng)
    if site == "host_corruption":       # detected, restored from round 0
        jp, tp = _policies(seed=6, fail_at={site: [1]})
        with tempfile.TemporaryDirectory() as jd, \
                tempfile.TemporaryDirectory() as td:
            got, _ = _pair(keys, vals, jp, tp, jdir=jd, tdir=td)
        assert got[-1].checksum_failures == 1
        return
    jp, tp = _policies(seed=1, fail_at={site: [0, 1]})
    jr, tr = _retries(max_retries=3)
    got, _ = _pair(keys, vals, jp, tp, jr, tr)
    st = got[-1]
    assert st.faults_injected == 2 and st.retries == 2
    assert st.degradations == 0
    assert st.h2d_bytes + st.d2h_bytes == (st.chunk_link_bytes +
                                           st.spill_link_bytes +
                                           st.retry_link_bytes)


def test_deterministic_fault_storm(rng):
    keys, vals = _data(rng)
    rates = {"chunk_upload": 0.08, "slab_upload": 0.08,
             "slab_download": 0.08, "merge_launch": 0.05}
    jp, tp = _policies(seed=11, rates=rates)
    jr, tr = _retries(max_retries=6)
    got, _ = _pair(keys, vals, jp, tp, jr, tr)
    assert got[-1].faults_injected > 0 and got[-1].retries > 0


# --------------------------- degradation ladder ------------------------------

def test_degradation_ladder_slab_kway_rechunk(rng):
    keys, vals = _data(rng)
    jp, tp = _policies(seed=3, fail_at={"slab_upload": list(range(6))})
    jr, tr = _retries(max_retries=1)
    got, _ = _pair(keys, vals, jp, tp, jr, tr)
    assert got[-1].degradations == 3
    assert got[-1].device_high_water_bytes <= BUDGET


def test_nonspill_kway_rung(rng):
    keys, vals = _data(rng, n=1200)
    jp, tp = _policies(seed=5, fail_at={"merge_launch": [0, 1]})
    jr, tr = _retries(max_retries=0)
    got, _ = _pair(keys, vals, jp, tp, jr, tr, chunk=300, tile=32,
                   spill_budget_bytes=None)
    assert got[-1].degradations >= 1


def test_ladder_exhaustion_raises_in_both(rng):
    keys = rng.integers(0, 2 ** 32, 64, dtype=np.uint32)
    for fp, rp, run in (
            (jfaults.FaultPolicy, jfaults.RetryPolicy, j_oocsort),
            (tfaults.FaultPolicy, tfaults.RetryPolicy,
             lambda *a, **k: oocsort(*a, device="cpu", **k))):
        with pytest.raises(Exception) as ei:
            run(keys, 16, engine="argsort", tile=TILE,
                spill_budget_bytes=BUDGET,
                faults=fp(seed=4, fail_at={"slab_upload": range(500)}),
                retry=rp(max_retries=0))
        assert type(ei.value).__name__ == "RetriesExhausted"


def test_corruption_without_checkpoint_raises(rng):
    keys, vals = _data(rng)
    with pytest.raises(tfaults.ChecksumError, match="host run"):
        oocsort(keys, CHUNK, values=vals, engine="argsort", tile=TILE,
                spill_budget_bytes=BUDGET, device="cpu",
                faults=tfaults.FaultPolicy(
                    seed=6, fail_at={"host_corruption": [1]}))


# --------------------------- kill-and-resume ---------------------------------

@pytest.mark.parametrize("dtype,kv,fatal_idx", [
    (np.uint32, True, 0),
    (np.uint32, True, 7),
    (np.float32, True, 7),
    (np.float32, False, 5),
])
def test_kill_and_resume_equals_reference(rng, dtype, kv, fatal_idx):
    keys, vals = _data(rng, dtype=dtype)
    vals = vals if kv else None
    kw = dict(engine="argsort", tile=TILE, spill_budget_bytes=BUDGET)
    jprobe = jfaults.FaultPolicy(seed=0)
    want = j_oocsort(keys, CHUNK, values=vals, return_stats=True,
                     faults=jprobe, **kw)
    rounds = want[-1].rounds_spilled
    probe = tfaults.FaultPolicy(seed=0)
    with tempfile.TemporaryDirectory() as ckpt:
        killer = tfaults.FaultPolicy(seed=7,
                                     fatal_at={"merge_launch": [fatal_idx]})
        with pytest.raises(tfaults.FatalFault):
            oocsort(keys, CHUNK, values=vals, faults=killer,
                    checkpoint_dir=ckpt, device="cpu", **kw)
        r = store.latest_step(ckpt)
        assert r is not None and r < rounds
        got = oocsort(None, 0, resume_from=ckpt, faults=probe,
                      spill_budget_bytes=BUDGET, return_stats=True,
                      device="cpu")
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    st = got[-1]
    assert st.rounds_spilled == rounds - r
    assert st.device_high_water_bytes <= BUDGET
    assert st.faults_injected == 0 and st.degradations == 0
    for site in ("slab_upload", "merge_launch", "slab_download"):
        assert probe.state().get(site, 0) == jprobe.state().get(site, 0)


def test_resume_values_like_and_new_dir(rng):
    keys, vals = _data(rng)
    want_k, want_v = j_oocsort(keys, CHUNK, values=vals, engine="argsort",
                               tile=TILE, spill_budget_bytes=BUDGET)
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        with pytest.raises(tfaults.FatalFault):
            oocsort(keys, CHUNK, values={"idx": vals}, engine="argsort",
                    tile=TILE, spill_budget_bytes=BUDGET,
                    checkpoint_dir=a, device="cpu",
                    faults=tfaults.FaultPolicy(
                        seed=9, fatal_at={"merge_launch": [2]}))
        got_k, got_v = oocsort(None, 0, resume_from=a, checkpoint_dir=b,
                               values_like={"idx": np.empty(0, np.uint32)},
                               device="cpu")
        assert store.latest_step(b) is not None          # re-published
        with pytest.raises(ValueError, match="leaves"):
            oocsort(None, 0, resume_from=a, device="cpu",
                    values_like=(np.empty(0), np.empty(0)))
    assert got_k.tobytes() == want_k.tobytes()
    assert set(got_v) == {"idx"} and got_v["idx"].tobytes() == \
        want_v.tobytes()


def test_resume_from_empty_dir_raises():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="no checkpointed rounds"):
            oocsort(None, 0, resume_from=d, device="cpu")


# --------------------------- the port's store --------------------------------

def test_store_atomic_publish_prune_and_refusal(rng):
    tree = {"k0000": rng.integers(0, 2**32, 100, dtype=np.uint32),
            "v0000_0": np.arange(100, dtype=np.float32),
            "meta": np.frombuffer(json.dumps({"a": 1}).encode(), np.uint8)}
    with tempfile.TemporaryDirectory() as d:
        # a half-written step (no rename yet) is invisible
        os.makedirs(os.path.join(d, ".tmp_step_9"))
        assert store.latest_step(d) is None
        for step in range(5):
            store.save_checkpoint(d, step, tree, keep=3)
        assert store.latest_steps(d) == [2, 3, 4]
        out = store.restore_blind(d, 4)
        assert set(out) == {f"['{k}']" for k in tree}
        for k, v in tree.items():
            got = out[f"['{k}']"]
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
        path = os.path.join(d, "step_0000000004", "chunk_000000.zlib")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        with pytest.raises(IOError, match="corrupt"):
            store.restore_blind(d, 4)
