"""The port's pass plan against ``repro.core.plan``, entry for entry.

Pass states come from the reference itself: the keys are advanced through
``repro``'s own counting passes, and at every pass each of the port's plan
tables (active segments, region blocks flat and packed, R3 merge rows, the
next-pass segment map and the bookkeeping updates) must equal the
reference's on the same state.  The kernel engine's segment table is held
to the reference's dense state on the same passes, and on hand-made states
at the edges.
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


def _pass_hist(ukeys, seg, done, p, cfg, a_max):
    """The (a_max, r) sub-bucket histogram of pass ``p`` on a state."""
    r = cfg.radix
    asid = jplan.active_segments(seg, done, a_max).index
    digit = jplan.digit_at(ukeys, p, 32, cfg.d)
    active = ~done
    idx = jnp.where(active, asid * r + digit, 0)
    return jnp.zeros((a_max * r,), jnp.int32).at[idx].add(
        active.astype(jnp.int32)).reshape(a_max, r)


CASES = [(TCFG, 0, 3000), (TCFG, 3, 3000), (PCFG, 0, 1500), (PCFG, 6, 1500)]


@pytest.mark.parametrize("cfg,ands,n", CASES)
def test_plan_tables_equal_reference_on_reference_states(rng, cfg, ands, n):
    x = entropy_keys(rng, n, ands)
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
        hist = _pass_hist(ukeys, seg, done, p, cfg, a_max)
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


def _padded(a, size, fill):
    out = np.full(size, fill, np.int64)
    out[:len(a)] = a
    return out


def _table_np(seg, done, s_max):
    """One (start, size, done) row per bucket of a dense state, in numpy,
    padded with (n, 0, False)."""
    seg, done = np.asarray(seg), np.asarray(done)
    n = seg.size
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    sizes = np.diff(np.r_[starts, n])
    return (_padded(starts, s_max, n), _padded(sizes, s_max, 0),
            _padded(done[starts], s_max, 0))


def _local_rows(seg, done, s_max):
    """``(starts, sizes, sortable)`` of the local sort derived from a dense
    state by its bucket boundaries, as the kernel engine's finish once
    derived them."""
    n = seg.shape[0]
    boundary = torch.ones(n, dtype=torch.bool)
    boundary[1:] = seg[1:] != seg[:-1]
    starts = static_nonzero(boundary, s_max, n)
    sizes = torch.cat([starts[1:], starts.new_full((1,), n)]) - starts
    sortable = (done[torch.clamp(starts, 0, n - 1).to(torch.int64)] &
                (starts < n))
    return starts, sizes, sortable


def _check_table_pass(seg, done, hist, cfg):
    """The segment table of a dense state and its one-pass update against
    the reference's dense state and bookkeeping."""
    n = seg.shape[0]
    a_max = jmodel.max_active_buckets(n, cfg)
    s_max = jmodel.max_total_buckets(n, cfg)
    start, size, flags = _table_np(seg, done, s_max)
    table = tplan.SegmentTable(torch.from_numpy(start).to(torch.int32),
                               torch.from_numpy(size).to(torch.int32),
                               torch.from_numpy(flags).to(torch.bool))
    if not np.asarray(seg).any():                     # the sort's start
        for got, want in zip(tplan.segment_table(n, s_max, bool(done[0]),
                                                 "cpu"), table):
            _eq(got, want)
    for got, want in zip(table, _local_rows(_t(seg), _t(done), s_max)):
        _eq(got, want)
    ref_a = jplan.active_segments(seg, done, a_max)
    got_a, rows = tplan.table_active(table, n, a_max)
    _eq(got_a.base, ref_a.base)
    _eq(got_a.size, ref_a.size)
    assert bool(tplan.table_any_active(table)) == bool((~done).any())

    gstart, gdone = jplan.merge_rows(hist, cfg.local_threshold,
                                     cfg.merge_threshold)
    dest_base = ref_a.base[:, None] + jnp.cumsum(hist, axis=1) - hist
    nseg, ndone = jplan.apply_pass_bookkeeping(seg, done, ref_a, hist,
                                               gstart, gdone, dest_base)
    nxt = tplan.advance_table(table, rows, _t(gstart), _t(gdone),
                              _t(dest_base), n)
    for got, want in zip(nxt, _table_np(nseg, ndone, s_max)):
        _eq(got, want)
    for got, want in zip(nxt, _local_rows(_t(nseg), _t(ndone), s_max)):
        _eq(got, want)


def _made_state(cfg, buckets):
    """Dense ``(seg, done, hist)`` of buckets ``(size, done, row)`` in
    position order, ``row`` the {digit: count} sub-buckets of an active
    one (summing to its size)."""
    n = sum(size for size, _, _ in buckets)
    a_max = jmodel.max_active_buckets(n, cfg)
    seg = np.repeat(np.arange(len(buckets), dtype=np.int32),
                    [size for size, _, _ in buckets])
    done = np.repeat([d for _, d, _ in buckets],
                     [size for size, _, _ in buckets])
    hist = np.zeros((a_max, cfg.radix), np.int32)
    active = [(size, row) for size, d, row in buckets if not d]
    for a, (size, row) in enumerate(active):
        assert sum(row.values()) == size > cfg.local_threshold
        for v, count in row.items():
            hist[a, v] = count
    return jnp.asarray(seg), jnp.asarray(done), jnp.asarray(hist)


# hand-made TCFG states (∂̂ 48, ∂ 32): most rows of the (a_max, r) table
# zero; active rows whose non-empty sub-buckets all lie below ∂ (every
# group done); n ≤ ∂̂ (the sort's start is its finish); every bucket done
EDGES = {
    "all_zero_rows": [(30, True, None), (500, False, {3: 100, 200: 400})],
    "below_merge": [(100, False, {2 * v: 4 for v in range(25)}),
                    (20, True, None), (60, False, {v: 3 for v in range(20)})],
    "tiny": [(40, True, None)],
    "all_done": [(40, True, None), (10, True, None), (48, True, None),
                 (1, True, None)],
}


@pytest.mark.parametrize("case", CASES + list(EDGES), ids=[
    "d8_uniform", "d8_and3", "d5_uniform", "d5_and6", *EDGES])
def test_segment_table_follows_the_dense_state(rng, case):
    """The table built from a dense state: its active rows are
    ``active_segments``' base and size, its rows the local sort's
    ``(starts, sizes, sortable)``, and one pass's ``advance_table`` gives
    the table of the reference's next state, on three passes of the
    reference's own states and on the edge states."""
    if isinstance(case, str):
        _check_table_pass(*_made_state(TCFG, EDGES[case]), TCFG)
        return
    cfg, ands, n = case
    x = entropy_keys(rng, n, ands)
    a_max = jmodel.max_active_buckets(n, cfg)
    for ukeys, seg, done, p in _reference_states(x, cfg, 3):
        _check_table_pass(seg, done,
                          _pass_hist(ukeys, seg, done, p, cfg, a_max), cfg)


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
