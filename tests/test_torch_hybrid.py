"""``repro_torch.hybrid_sort`` against ``repro.core.hybrid_sort``, byte for byte.

Both packages sort the same numpy inputs; keys and every value leaf must be
byte-identical and ``SortStats`` equal, for both port engines that run on
the CPU (``argsort``, and ``kernel`` through the kernels' plain versions),
over dtypes, key / KV / pytree values, the adaptive schedule on and off,
compressed keys and ``max_passes`` truncation.  The reference runs its
``argsort`` engine, which its own tests pin byte-identical to its kernel
engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import SortConfig as JConfig  # noqa: E402
from repro.core import hybrid_sort as j_sort  # noqa: E402
from repro_torch import hybrid_sort  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.interop import (config_from_reference,  # noqa: E402
                                      to_numpy, tree_flatten)
from repro_torch.kernels import bitonic, fused  # noqa: E402
from conftest import entropy_keys  # noqa: E402

TCFG = JConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)
PCFG = JConfig(d=5, kpb=32, local_threshold=16, merge_threshold=8)
PORT_ENGINES = ("argsort", "kernel")


def _keys(rng, dtype, n):
    if dtype == np.float32:
        x = (rng.standard_normal(n) * 1e3).astype(dtype)
        if n >= 8:
            x[:4] = [0.0, -0.0, np.inf, -np.inf]
            x[4:8] = np.array([0x7FC00000, 0xFFC00000, 0x7F800001,
                               0xFF812345], np.uint32).view(np.float32)
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    return tree_flatten(tree)[0]


def _as_bytes(a):
    return (to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            ).tobytes()


def _check(x, values, cfg, engines=PORT_ENGINES, **kw):
    """Run the reference once and the port once per engine; compare."""
    jvals = None if values is None else jax.tree.map(jnp.asarray, values)
    ref = j_sort(jnp.asarray(x), jvals, cfg=cfg, engine="argsort",
                 return_stats=True, **kw)
    want_stats = tuple(int(v) for v in ref[-1])
    pcfg = config_from_reference(dataclasses.asdict(cfg))
    for engine in engines:
        got = hybrid_sort(x, values, cfg=pcfg, engine=engine,
                          return_stats=True, device="cpu", **kw)
        assert _as_bytes(got[0]) == _as_bytes(ref[0]), engine
        assert got[0].dtype == torch.from_numpy(np.zeros(1, x.dtype)).dtype
        if values is not None:
            gl, wl = _leaves(got[1]), jax.tree.leaves(ref[1])
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                assert _as_bytes(g) == _as_bytes(w), engine
        assert tuple(int(v) for v in got[-1]) == want_stats, engine
    return want_stats


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("n", [0, 1, 2, 257, 4096])
def test_keys_parity(rng, dtype, n):
    _check(_keys(rng, dtype, n), None, TCFG)


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
@pytest.mark.parametrize("n", [2, 257, 4096])
def test_kv_parity(rng, dtype, n):
    x = _keys(rng, dtype, n)
    _check(x, np.arange(n, dtype=np.int32), TCFG)


@pytest.mark.parametrize("n", [257, 3000])
def test_partial_last_digit_parity(rng, n):
    x = _keys(rng, np.uint32, n)
    _check(x, rng.standard_normal(n).astype(np.float32), PCFG)


def test_value_pytree_parity(rng):
    n = 3000
    x = entropy_keys(rng, n, 1)
    values = {"idx": np.arange(n, dtype=np.int32),
              "w": (rng.standard_normal(n).astype(np.float32),
                    rng.integers(0, 2**16, n, dtype=np.uint16)),
              "flag": rng.integers(0, 255, n, dtype=np.uint8)}
    _check(x, values, TCFG)


@pytest.mark.parametrize("ands", [0, 3, 8, 30])
@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_schedule_parity(rng, ands, adaptive):
    x = entropy_keys(rng, 4000, ands)
    _check(x, np.arange(4000, dtype=np.int32), TCFG, adaptive=adaptive)


def test_elision_happens_and_matches(rng):
    """Two big top-byte buckets whose second byte is a function of the top
    byte: the second pass has one digit per segment and is elided (through
    the lookahead histogram), identically in both packages."""
    n = 3000
    top = rng.integers(0, 2, n, dtype=np.uint32)
    x = ((np.uint32(0x10) + top * np.uint32(0x80)) << np.uint32(24)) | \
        ((np.uint32(0x33) + top * np.uint32(0x11)) << np.uint32(16)) | \
        rng.integers(0, 2**16, n, dtype=np.uint32)
    stats = _check(x, np.arange(n, dtype=np.int32), TCFG)
    assert stats[4] >= 1


@pytest.mark.parametrize("ands", [0, 6])
def test_compress_parity(rng, ands):
    x = entropy_keys(rng, 4000, ands)
    _check(x, np.arange(4000, dtype=np.int32), TCFG, compress=True)


@pytest.mark.parametrize("max_passes", [0, 1, 2])
def test_max_passes_parity(rng, max_passes):
    x = entropy_keys(rng, 4000, 3)
    _check(x, np.arange(4000, dtype=np.int32), TCFG, max_passes=max_passes)


@pytest.mark.parametrize("dtype", [np.uint64, np.int64])
def test_64bit_parity(rng, dtype):
    x = _keys(rng, dtype, 3000)
    with jax.enable_x64(True):
        _check(x, np.arange(3000, dtype=np.int64), TCFG)
        _check(x >> dtype(40), None, TCFG, compress=True)


def test_scan_engine_parity(rng):
    x = entropy_keys(rng, 3000, 2)
    _check(x, np.arange(3000, dtype=np.int32), TCFG, engines=("scan",))


def test_kernel_engine_census_on_cpu(rng, monkeypatch):
    """On the CPU the kernel engine's plumbing makes the kernel census: one
    prologue histogram, one fused pass per executed pass, at most one
    local-sort launch per size class (counted at the wrapper calls)."""
    calls = {"hist": 0, "pass": 0, "local": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused, "initial_histogram",
                        counting("hist", fused.initial_histogram))
    monkeypatch.setattr(fused, "fused_counting_pass",
                        counting("pass", fused.fused_counting_pass))
    monkeypatch.setattr(thybrid, "segmented_local_sort",
                        counting("local", thybrid.segmented_local_sort))
    n = 4000
    pcfg = config_from_reference(dataclasses.asdict(TCFG))
    for ands in (0, 3, 30):
        for key in calls:
            calls[key] = 0
        x = entropy_keys(rng, n, ands)
        _, stats = hybrid_sort(x, cfg=pcfg, engine="kernel",
                               return_stats=True, device="cpu")
        assert calls["hist"] == 1
        assert calls["pass"] == stats.counting_passes
        assert calls["local"] == int(stats.used_local_sort)
    classes = thybrid.local_sort_classes(n, pcfg)
    sorts = []
    monkeypatch.setattr(bitonic, "sort_segments_stable",
                        lambda *a: sorts.append(a[4]))
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "sort_segments_stable",
                        lambda *a: sorts.append(a[4]))
    hybrid_sort(entropy_keys(rng, n, 0), cfg=pcfg, engine="kernel",
                device="cpu")
    assert sorts == [length for length, _ in classes]


@pytest.mark.parametrize("opts", [{}, {"max_passes": 1}, {"compress": True}],
                         ids=["full", "max_passes_1", "compress"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.float32])
def test_kernel_engine_keeps_no_per_key_bucket_state(rng, monkeypatch, dtype,
                                                     opts):
    """The kernel engine keeps its bucket state as a segment table: with
    the dense per-key plan made to raise, its keys, values and stats equal
    the ``argsort`` engine's.  Half the keys repeat 20 values (buckets that
    stay active to the last digit, so ``max_passes=1`` leaves some
    unfinished and unsorted)."""
    x = _keys(rng, dtype, 3000)
    x[:1500] = x[1500:][rng.integers(0, 20, 1500)]
    vals = np.arange(x.size, dtype=np.int32)
    pcfg = config_from_reference(dataclasses.asdict(TCFG))
    want = hybrid_sort(x, vals, cfg=pcfg, engine="argsort",
                       return_stats=True, device="cpu", **opts)

    def dense(*args, **kw):
        raise AssertionError("the kernel engine kept per-key bucket state")
    monkeypatch.setattr(tplan, "active_segments", dense)
    monkeypatch.setattr(tplan, "apply_pass_bookkeeping", dense)
    got = hybrid_sort(x, vals, cfg=pcfg, engine="kernel", return_stats=True,
                      device="cpu", **opts)
    assert _as_bytes(got[0]) == _as_bytes(want[0])
    assert _as_bytes(got[1]) == _as_bytes(want[1])
    assert got[2] == want[2]
    if "max_passes" in opts:                  # some buckets left unsorted
        assert got[2].counting_passes == 1
        full = hybrid_sort(x, cfg=pcfg, engine="kernel", device="cpu")
        assert _as_bytes(got[0]) != _as_bytes(full)


def test_engine_resolution():
    from repro_torch.core.ranks import resolve_engine
    assert resolve_engine(None, "cpu") == "argsort"
    assert resolve_engine("auto", torch.device("cuda", 0)) == "kernel"
    assert resolve_engine("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        resolve_engine("bogus", "cpu")


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_8bit_keys_full_digit_parity(rng, dtype):
    """8-bit keys with d = 8: the digit mask 0xFF does not fit the int8
    carrier, so digits are widened before masking."""
    x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, 3000,
                     dtype=dtype, endpoint=True)
    _check(x, np.arange(3000, dtype=np.int32), TCFG)
