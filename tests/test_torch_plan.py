"""The port's pass plan against ``repro.core.plan``, entry for entry.

Pass states come from the reference itself: the keys are advanced through
``repro``'s own counting passes, and at every pass each of the port's plan
tables (active segments, region blocks flat and packed, R3 merge rows, the
next-pass segment map and the bookkeeping updates) must equal the
reference's on the same state.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.ops import static_nonzero  # noqa: E402
from conftest import entropy_keys  # noqa: E402
from test_torch_gpu import _r3_edge_rows  # noqa: E402

TCFG = jmodel.SortConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)
PCFG = jmodel.SortConfig(d=5, kpb=32, local_threshold=16, merge_threshold=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape
    assert np.array_equal(p.astype(np.int64), r.astype(np.int64))


def _reference_states(x, cfg, passes):
    """(ukeys, seg_id, done, p) before each of the first reference passes."""
    n = x.shape[0]
    k = 32
    a_max = jmodel.max_active_buckets(n, cfg)
    body = functools.partial(jhybrid._counting_pass_jnp, k=k, d=cfg.d, lo=0,
                             a_max=a_max, nd=jmodel.num_digits(k, cfg.d),
                             cfg=cfg, engine="argsort", adaptive=False)
    state = (jnp.asarray(x), (), jnp.zeros(n, jnp.int32),
             jnp.full(n, n <= cfg.local_threshold), jnp.bool_(False),
             jnp.int32(0), jnp.int32(0), jnp.int32(0))
    for p in range(passes):
        yield state[0], state[2], state[3], p
        state = body(state)


CASES = [(TCFG, 0, 3000), (TCFG, 3, 3000), (PCFG, 0, 1500), (PCFG, 6, 1500)]


@pytest.mark.parametrize("cfg,ands,n", CASES)
def test_plan_tables_equal_reference_on_reference_states(rng, cfg, ands, n):
    x = entropy_keys(rng, n, ands)
    r = cfg.radix
    a_max = jmodel.max_active_buckets(n, cfg)
    g_max = jplan.max_region_blocks(n, cfg.kpb, a_max)
    assert tplan.max_region_blocks(n, cfg.kpb, a_max) == g_max
    for ukeys, seg, done, p in _reference_states(x, cfg, 3):
        seg_t, done_t = _t(seg), _t(done)
        ref_a = jplan.active_segments(seg, done, a_max)
        got_a = tplan.active_segments(seg_t, done_t, a_max)
        for name in ("base", "size", "index", "boundary"):
            _eq(getattr(got_a, name), getattr(ref_a, name))

        for batch in (None, 1, 8):
            ref_b = jplan.make_region_blocks(ref_a.base, ref_a.size, n,
                                             cfg.kpb, g_max, batch=batch)
            got_b = tplan.make_region_blocks(got_a.base, got_a.size, n,
                                             cfg.kpb, g_max, batch=batch)
            for name in ref_b._fields:
                _eq(getattr(got_b, name), getattr(ref_b, name))

        digit = jplan.digit_at(ukeys, p, 32, cfg.d)
        _eq(tplan.digit_at(_t(ukeys).view(torch.int32), p, 32, cfg.d), digit)
        active = ~done
        idx = jnp.where(active, ref_a.index * r + digit, 0)
        hist = jnp.zeros((a_max * r,), jnp.int32).at[idx].add(
            active.astype(jnp.int32)).reshape(a_max, r)
        hist_t = _t(hist)
        ref_g = jplan.merge_rows(hist, cfg.local_threshold,
                                 cfg.merge_threshold)
        got_g = tplan.merge_rows(hist_t, cfg.local_threshold,
                                 cfg.merge_threshold)
        _eq(got_g[0], ref_g[0])
        _eq(got_g[1], ref_g[1])
        _eq(tplan.next_active_table(hist_t, cfg.local_threshold, a_max),
            jplan.next_active_table(hist, cfg.local_threshold, a_max))
        dest_base = ref_a.base[:, None] + jnp.cumsum(hist, axis=1) - hist
        ref_s, ref_d = jplan.apply_pass_bookkeeping(
            seg, done, ref_a, hist, *ref_g, dest_base)
        got_s, got_d = tplan.apply_pass_bookkeeping(
            seg_t, done_t, got_a, hist_t, *got_g, _t(dest_base))
        _eq(got_s, ref_s)
        _eq(got_d, ref_d)


@pytest.mark.parametrize("k,d,lo", [(32, 8, 0), (32, 5, 0), (32, 8, 9),
                                    (64, 8, 3), (16, 5, 2)])
def test_digit_windows_equal_reference(k, d, lo):
    for p in range(-(-k // d) + 1):
        assert tplan.digit_window(p, k, d, lo=lo) == tuple(
            int(v) for v in jplan.digit_window(p, k, d, lo=lo))


def test_merge_rows_edge_rows(rng):
    """Zeros, single big sub-buckets and runs right at the thresholds."""
    hist = rng.integers(0, 60, (16, 32)).astype(np.int32)
    hist[rng.random((16, 32)) < 0.4] = 0
    hist[3] = 0
    hist[4, 7] = 49
    hist[5] = [8] * 32
    ref = jplan.merge_rows(jnp.asarray(hist), 48, 32)
    got = tplan.merge_rows(_t(hist), 48, 32)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


@pytest.mark.parametrize("kind", range(7), ids=[
    "all_zero", "zero_runs", "at_local", "fill_merge", "near_int_max", "tiny",
    "each_breaks"])
@pytest.mark.parametrize("lt,mt", [(9216, 3000), (48, 32)])
def test_merge_rows_edge_rows_wide(kind, lt, mt):
    """R3 at r = 4096 (d = 12) on each edge row of the card's test (beside a
    row of small sizes), the port against the reference's
    ``plan.merge_rows``."""
    rows = _r3_edge_rows(np.random.default_rng(kind + lt), 4096, lt, mt)
    hist = rows[[kind, 5]]
    ref = jplan.merge_rows(jnp.asarray(hist), lt, mt)
    got = tplan.merge_rows(_t(hist), lt, mt)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


@pytest.mark.parametrize("size", [0, 1, 5, 40])
def test_static_nonzero_equals_jnp_nonzero(rng, size):
    mask = rng.random(37) < 0.3
    want = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=37)[0]
    _eq(static_nonzero(_t(mask), size, 37), want)
