"""``repro_torch.lsd_sort`` against ``repro.core.lsd_sort``, byte for byte.

Both packages sort the same numpy inputs; keys and every value leaf must be
byte-identical and the executed pass counts equal, for the port's three
engines (``kernel`` through the kernels' plain versions on the CPU), over
digit widths, key dtypes, pytree values, duplicates, all-equal keys, no
keys, and the adaptive window on and off.  The reference runs its
``argsort`` engine, which its own tests pin byte-identical to its kernel
engine; one small case also runs the reference's kernel engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import lsd_sort as j_lsd  # noqa: E402
from repro_torch import lsd_sort  # noqa: E402
from repro_torch.core import lsd as tlsd  # noqa: E402
from repro_torch.core.interop import to_numpy, tree_flatten  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402

ENGINES = ("argsort", "scan", "kernel")
#: the port's kernel engine at a small block (the result does not depend
#: on it)
KPB = 64


def _bytes(a):
    return (to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            ).tobytes()


def _keys(rng, dtype, n):
    if dtype == np.float32:
        x = (rng.standard_normal(n) * 1e3).astype(dtype)
        x[:8] = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                          0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345],
                         np.uint32).view(np.float32)
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _check(x, values, d, engines=ENGINES, **kw):
    """The reference once, the port once per engine: keys, leaves and the
    pass count equal.  Returns the pass count."""
    jvals = None if values is None else jax.tree.map(jnp.asarray, values)
    ref = j_lsd(jnp.asarray(x), jvals, d=d, engine="argsort",
                return_passes=True, **kw)
    for engine in engines:
        got = lsd_sort(x, values, d=d, engine=engine, kpb=KPB,
                       return_passes=True, device="cpu", **kw)
        assert len(got) == len(ref)
        assert _bytes(got[0]) == _bytes(ref[0]), engine
        if values is not None:
            gl, wl = tree_flatten(got[1])[0], jax.tree.leaves(ref[1])
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                assert _bytes(g) == _bytes(w), engine
        assert got[-1] == ref[-1], engine
    return ref[-1]


@pytest.mark.parametrize("d", [2, 4, 5, 7, 8, 9, 12, 16])
def test_digit_widths(rng, d):
    x = _keys(rng, np.uint32, 700)
    passes = _check(x, np.arange(700, dtype=np.int32), d)
    assert passes == -(-32 // d)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.uint32,
                                   np.float32])
def test_key_dtypes(rng, dtype):
    x = _keys(rng, dtype, 1000)
    _check(x, np.arange(1000, dtype=np.int32), 5)


@pytest.mark.parametrize("dtype", [np.uint64, np.int64])
def test_64bit_keys(rng, dtype):
    x = _keys(rng, dtype, 600)
    with jax.enable_x64(True):
        _check(x, np.arange(600, dtype=np.int64), 8)


def test_pytree_values(rng):
    x = _keys(rng, np.uint32, 900)
    values = {"idx": np.arange(900, dtype=np.int32),
              "w": rng.standard_normal(900).astype(np.float32)}
    _check(x, values, 5)


def test_duplicates_are_stable(rng):
    x = rng.integers(0, 8, 2000).astype(np.uint32)
    idx = np.arange(2000, dtype=np.int32)
    _check(x, idx, 4)
    out, vals = lsd_sort(x, idx, d=4, engine="kernel", kpb=KPB, device="cpu")
    assert np.array_equal(vals.numpy(), np.argsort(x, kind="stable"))


def test_all_equal_and_empty(rng):
    x = np.full(300, 0xDEADBEEF, np.uint32)
    assert _check(x, np.arange(300, dtype=np.int32), 5) == 0
    empty = np.zeros(0, np.uint32)
    assert _check(empty, None, 5) == 0
    assert _check(empty, np.zeros(0, np.int32), 5) == 0


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_window(rng, adaptive):
    x = (_keys(rng, np.uint32, 800) & np.uint32(0x00FFF000)) | np.uint32(7)
    passes = _check(x, np.arange(800, dtype=np.int32), 5, adaptive=adaptive)
    assert passes == (3 if adaptive else 7)


def test_kernel_engine_census_on_cpu(rng, monkeypatch):
    """On the CPU the kernel engine's plumbing makes the kernel census: one
    prologue histogram and one fused pass per executed pass (counted at the
    wrapper calls), the prologue also with an empty window."""
    calls = {"hist": 0, "pass": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused, "initial_histogram",
                        counting("hist", fused.initial_histogram))
    monkeypatch.setattr(fused, "fused_counting_pass",
                        counting("pass", fused.fused_counting_pass))
    cases = ((_keys(rng, np.uint32, 1500), 5, True),
             (_keys(rng, np.uint32, 1500) & np.uint32(0xFF00), 4, True),
             (np.full(100, 5, np.uint32), 5, True),
             (_keys(rng, np.int16, 1000), 3, False))
    for x, d, adaptive in cases:
        for key in calls:
            calls[key] = 0
        _, passes = lsd_sort(x, d=d, engine="kernel", kpb=KPB,
                             adaptive=adaptive, return_passes=True,
                             device="cpu")
        assert calls["hist"] == 1
        assert calls["pass"] == passes
        assert calls["hist"] + calls["pass"] == passes + 1


def test_reference_kernel_engine_spot_check(rng):
    """The reference's own kernel engine (Pallas in interpret mode) at a
    tiny size gives the same bytes as the port's kernel engine."""
    x = _keys(rng, np.uint32, 500)
    idx = np.arange(500, dtype=np.int32)
    ref_k, ref_v = j_lsd(jnp.asarray(x), jnp.asarray(idx), d=8,
                         engine="kernel", kpb=64)
    got_k, got_v = lsd_sort(x, idx, d=8, engine="kernel", kpb=64,
                            device="cpu")
    assert _bytes(got_k) == _bytes(ref_k)
    assert _bytes(got_v) == _bytes(ref_v)


def test_kernel_engine_blocks_do_not_change_the_result(rng):
    x = _keys(rng, np.uint32, 3000)
    idx = np.arange(3000, dtype=np.int32)
    want = lsd_sort(x, idx, d=8, engine="argsort", device="cpu")
    for kpb in (8, 64, 1024, 6912):
        got = lsd_sort(x, idx, d=8, engine="kernel", kpb=kpb, device="cpu")
        assert _bytes(got[0]) == _bytes(want[0]) and \
            _bytes(got[1]) == _bytes(want[1]), kpb


def test_engine_resolution_and_input_checks():
    x = torch.tensor([3, 1, 2], dtype=torch.int32)
    assert lsd_sort(x).tolist() == [1, 2, 3]            # auto on the CPU
    with pytest.raises(ValueError, match="1-D"):
        lsd_sort(x.reshape(1, 3))
    with pytest.raises(ValueError, match="unknown engine"):
        lsd_sort(x, engine="bogus")
    assert tlsd.lsd_sort is lsd_sort
