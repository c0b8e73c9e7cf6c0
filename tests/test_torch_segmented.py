"""The port's single-pass partition and segmented primitives against the
reference's, byte for byte: ``plan.lsd_digit_window``,
``plan.single_pass_partition``, ``segmented.counting_partition``,
``capacity_dispatch``, ``merge_sorted`` and ``multiway_merge``.

The partition runs the port's three engines (``kernel`` through the
kernels' plain versions on the CPU) against the reference's ``argsort``
engine, over bucket counts on both sides of each digit width, including
the counts where real ids share digit r - 1 with the sentinel padding
(256, 512, 65 536); one small case also runs the reference's kernel
engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jplan  # noqa: E402
from repro.core import segmented as jseg  # noqa: E402
from repro_torch.core import plan, segmented  # noqa: E402
from repro_torch.core.interop import to_numpy  # noqa: E402

ENGINES = ("argsort", "scan", "kernel")


def _np(a):
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("d", [1, 3, 5, 8, 16])
def test_lsd_digit_window(d):
    for k in (8, 16, 32, 64):
        for lo in (0, 3, k // 2):
            for p in range(-(-(k - lo) // d)):
                want = tuple(int(v) for v in
                             jplan.lsd_digit_window(p, k, d, lo=lo))
                assert plan.lsd_digit_window(p, k, d, lo=lo) == want


def _ids(rng, num_buckets, m):
    ids = rng.integers(0, num_buckets, m).astype(np.int32)
    ids[: m // 8] = num_buckets - 1          # the sentinel's digit when
    rng.shuffle(ids)                         # num_buckets is a power of 2
    return ids


@pytest.mark.parametrize("num_buckets", [1, 2, 8, 255, 256, 257, 384, 512,
                                         513, 65536])
def test_single_pass_partition(rng, num_buckets):
    ids = _ids(rng, num_buckets, 3000)
    want = jplan.single_pass_partition(jnp.asarray(ids), num_buckets,
                                       engine="argsort")
    for engine in ENGINES:
        got = plan.single_pass_partition(torch.from_numpy(ids), num_buckets,
                                         engine=engine)
        for g, w in zip(got, want):
            assert _same(g, w), (engine, num_buckets)


@pytest.mark.parametrize("m", [0, 1, 7, 1025])
def test_single_pass_partition_sizes(rng, m):
    ids = _ids(rng, 40, max(m, 1))[:m]
    want = jplan.single_pass_partition(jnp.asarray(ids), 40,
                                       engine="argsort")
    for engine in ENGINES:
        got = plan.single_pass_partition(torch.from_numpy(ids), 40,
                                         engine=engine)
        for g, w in zip(got, want):
            assert _same(g, w), (engine, m)


def test_single_pass_partition_reference_kernel(rng):
    """The reference's own kernel engine (Pallas in interpret mode) on a
    small input gives what the port's kernel engine gives."""
    ids = _ids(rng, 300, 700)
    want = jplan.single_pass_partition(jnp.asarray(ids), 300, engine="kernel",
                                       kpb=64)
    got = plan.single_pass_partition(torch.from_numpy(ids), 300,
                                     engine="kernel", kpb=64)
    for g, w in zip(got, want):
        assert _same(g, w)


def test_bincount_takes_jnp_semantics():
    ids = torch.tensor([-3, 0, 1, 1, 5, 9], dtype=torch.int32)
    want = jnp.bincount(jnp.asarray(ids.numpy()), length=5)
    assert np.array_equal(plan.bincount(ids, 5).numpy(), np.asarray(want))


@pytest.mark.parametrize("num_buckets", [3, 256, 384])
def test_counting_partition(rng, num_buckets):
    ids = _ids(rng, num_buckets, 2500)
    want = jseg.counting_partition(jnp.asarray(ids), num_buckets,
                                   engine="argsort")
    for engine in ENGINES:
        got = segmented.counting_partition(torch.from_numpy(ids), num_buckets,
                                           engine=engine)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert _same(g, w), engine


@pytest.mark.parametrize("capacity", [1, 4, 40])
def test_capacity_dispatch(rng, capacity):
    """Every field equal, overflowing buckets dropped as the reference
    drops them."""
    ids = rng.zipf(1.5, 600).clip(1, 24).astype(np.int32) - 1
    want = jseg.capacity_dispatch(jnp.asarray(ids), 24, capacity,
                                  engine="argsort")
    assert not bool(np.asarray(want.kept).all()) or capacity == 40
    for engine in ENGINES:
        got = segmented.capacity_dispatch(torch.from_numpy(ids), 24, capacity,
                                          engine=engine)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert _same(g, w), engine


def _sorted_runs(rng, dtype, s, length):
    if dtype == np.float32:
        x = rng.integers(-6, 6, (s, length)).astype(np.float32)
        x[0, :6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -np.nan]
        x[-1, :3] = [np.nan, -0.0, 0.0]
        return np.sort(x, axis=1)
    info = np.iinfo(dtype)
    lo, hi = (info.min, info.max) if dtype != np.int32 else (-20, 20)
    x = rng.integers(lo, hi, (s, length), dtype=dtype, endpoint=True)
    x[:, ::3] = x[0, 0]                         # duplicates across runs
    return np.sort(x, axis=1)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint64])
def test_merge_sorted(rng, dtype):
    with jax.enable_x64(np.dtype(dtype).itemsize == 8):
        runs = _sorted_runs(rng, dtype, 2, 300)
        a, b = runs[0][:217], runs[1]
        va = np.arange(217, dtype=np.int32)
        vb = np.arange(1000, 1300, dtype=np.int32)
        want = jseg.merge_sorted(jnp.asarray(a), jnp.asarray(b))
        got = segmented.merge_sorted(torch.from_numpy(a), torch.from_numpy(b))
        assert _same(got, want)
        want = jseg.merge_sorted(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(va), jnp.asarray(vb))
        got = segmented.merge_sorted(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(va),
                                     torch.from_numpy(vb))
        assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint64])
@pytest.mark.parametrize("s", [1, 3, 4])
def test_multiway_merge(rng, dtype, s):
    with jax.enable_x64(np.dtype(dtype).itemsize == 8):
        runs = _sorted_runs(rng, dtype, s, 64)
        vals = np.arange(s * 64, dtype=np.uint32).reshape(s, 64)
        want = jseg.multiway_merge(jnp.asarray(runs))
        got = segmented.multiway_merge(torch.from_numpy(runs))
        assert _same(got, want)
        want = jseg.multiway_merge(jnp.asarray(runs), jnp.asarray(vals))
        got = segmented.multiway_merge(torch.from_numpy(runs),
                                       torch.from_numpy(vals))
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_search_order_is_the_reference_order():
    """Every zero equal, every NaN equal and last, as jnp.searchsorted
    takes them."""
    x = np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan, -np.nan],
                 np.float32)
    order = segmented.search_order(torch.from_numpy(x)).tolist()
    assert order[:2] == sorted(order[:2]) and order[1] < order[2]
    assert order[2] == order[3] < order[4] < order[5] < order[6] == order[7]
    q = np.array([0.0, -0.0, np.nan, np.inf], np.float32)
    s = np.sort(x)
    for side in ("left", "right"):
        want = np.asarray(jnp.searchsorted(jnp.asarray(s), jnp.asarray(q),
                                           side=side))
        got = torch.searchsorted(segmented.search_order(torch.from_numpy(s)),
                                 segmented.search_order(torch.from_numpy(q)),
                                 side=side).numpy()
        assert np.array_equal(got, want), side
