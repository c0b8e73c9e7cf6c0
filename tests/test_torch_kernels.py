"""Each kernel's plain PyTorch version against the JAX kernel it ports.

The reference kernels run in Pallas interpret mode on the same inputs; the
port's wrappers, given CPU tensors, run the plain versions (the CUDA kernels
themselves are held to these on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``).  Every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import plan as jplan  # noqa: E402
from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_rows_stable as j_bitonic  # noqa: E402
from repro.kernels.histogram import radix_histogram as j_hist  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bitonic import bitonic_sort_rows_stable  # noqa: E402
from repro_torch.kernels.histogram import digit_total, radix_histogram  # noqa: E402
from conftest import entropy_keys  # noqa: E402


def _t(x):
    """numpy unsigned keys -> the port's carrier (signed twin, same bits)."""
    x = np.asarray(x)
    if x.dtype.kind == "u":
        x = x.view(np.dtype(f"i{x.dtype.itemsize}"))
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t, like=None):
    a = t.numpy()
    return a.view(like) if like is not None else a


# ------------------------------ histogram ---------------------------------

@pytest.mark.parametrize("t,kpb", [(1, 256), (4, 512)])
@pytest.mark.parametrize("shift,width", [(24, 8), (0, 8), (8, 5), (28, 4)])
def test_histogram_plain_equals_kernel(rng, t, kpb, shift, width):
    keys = rng.integers(0, 2**32, (t, kpb), dtype=np.uint32)
    want = np.asarray(j_hist(jnp.asarray(keys), shift, width, interpret=True))
    got = radix_histogram(_t(keys), shift, width)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    total = digit_total(_t(keys.reshape(-1)), t * kpb, shift, width)
    assert np.array_equal(total.numpy(), want.sum(0))


@pytest.mark.parametrize("ands", [0, 3, 30])
def test_histogram_plain_skewed(rng, ands):
    x = entropy_keys(rng, 4096, ands).reshape(4, 1024)
    want = np.asarray(j_hist(jnp.asarray(x), 24, 8, interpret=True))
    assert np.array_equal(radix_histogram(_t(x), 24, 8).numpy(), want)


def test_histogram_plain_all_equal_and_64bit(rng):
    x = np.full((2, 512), 0xDEADBEEF, np.uint32)
    want = np.asarray(j_hist(jnp.asarray(x), 16, 8, interpret=True))
    assert np.array_equal(radix_histogram(_t(x), 16, 8).numpy(), want)
    y = rng.integers(0, 2**63, (2, 256), dtype=np.uint64) | np.uint64(1 << 63)
    digits = (y >> np.uint64(56)) & np.uint64(0xFF)
    got = radix_histogram(_t(y), 56, 8).numpy()
    for row in range(2):
        assert np.array_equal(got[row], np.bincount(digits[row].astype(
            np.int64), minlength=256))


@pytest.mark.parametrize("n,kpb,lo,width", [(1000, 64, 24, 8), (777, 32, 27, 5),
                                            (64, 64, 0, 8)])
def test_initial_histogram_equals_reference(rng, n, kpb, lo, width):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    (jk, _), _ = jfused.make_ping_pong(jnp.asarray(x), (), kpb)
    want = jfused.initial_histogram(jk, n, lo, width, 256, 3, kpb,
                                    interpret=True)
    (tk, _), _ = tfused.make_ping_pong(_t(x), (), kpb)
    assert np.array_equal(_np(tk, np.uint32), np.asarray(jk))
    got = tfused.initial_histogram(tk, n, lo, width, 256, 3, kpb)
    assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------- fused counting pass ---------------------------

def _fused_both(rng, x, bounds, n, kpb, sc, nsid, a_max, r, vals=(),
                batch=None, lookahead=False, inert=0):
    """One fused pass through the reference kernel (interpret mode) and the
    port's plain version on the same tables; returns both outputs.  With
    ``inert``, the port's flat table gets that many count-0 rows before
    every region start but the first."""
    lo, width = int(sc[0]), int(sc[1])
    base = np.array([b for b, _ in bounds] + [n] * (a_max - len(bounds)),
                    np.int32)
    size = np.array([s for _, s in bounds] + [0] * (a_max - len(bounds)),
                    np.int32)
    hist = np.zeros((a_max, r), np.int32)
    for i, (b, s) in enumerate(bounds):
        hist[i] = np.bincount((x[b:b + s] >> lo) & ((1 << width) - 1),
                              minlength=r)
    base_excl = (base[:, None] + np.cumsum(hist, axis=1) - hist).astype(
        np.int32)
    g_max = jplan.max_region_blocks(n, kpb, a_max)
    jblocks = jplan.make_region_blocks(jnp.asarray(base), jnp.asarray(size),
                                       n, kpb, g_max, batch=batch)
    with jax.enable_x64(True):                 # 64-bit value leaves
        (ck, cv), (ak, av) = jfused.make_ping_pong(
            jnp.asarray(x), tuple(jnp.asarray(v) for v in vals), kpb)
        want = jfused.fused_counting_pass(
            ck, cv, ak, av, jnp.asarray(sc, jnp.int32), *jblocks,
            jnp.asarray(base_excl), jnp.asarray(nsid, jnp.int32), kpb=kpb,
            r=r, a_max=a_max, n=n, interpret=True, lookahead=lookahead)
        want = jax.tree.map(np.asarray, want)
    tblocks = tplan.make_region_blocks(_t(base), _t(size), n, kpb, g_max,
                                       batch=batch)
    if inert:
        fills = (a_max, 0, 1, 0, 0)            # seg, off, reset, count, active
        starts = torch.nonzero((tblocks.reset == 1) & (tblocks.count > 0))
        cuts = [0] + starts.flatten().tolist()[1:] + [g_max]
        tblocks = type(tblocks)(*(torch.cat(sum(
            ([t[a:b], t.new_full((inert,), f)] for a, b in
             zip(cuts[:-1], cuts[1:])), [])[:-1])
            for t, f in zip(tblocks, fills)))
        assert len(cuts) > 2
        assert tblocks.count.numel() == g_max + inert * (len(cuts) - 2)
    (tk, tv), (tak, tav) = tfused.make_ping_pong(
        _t(x), tuple(_t(v) for v in vals), kpb)
    got = tfused.fused_counting_pass(
        tk, tv, tak, tav, [int(v) for v in sc], *tblocks, _t(base_excl),
        _t(np.asarray(nsid, np.int32)), kpb=kpb, r=r, a_max=a_max, n=n,
        lookahead=lookahead)
    return want, got


def _assert_pass_equal(want, got, n):
    assert _np(got[0])[:n].tobytes() == np.asarray(want[0])[:n].tobytes()
    for wv, gv in zip(want[1], got[1]):
        assert _np(gv)[:n].tobytes() == np.asarray(wv)[:n].tobytes()
    assert len(want) == len(got)
    for wh, gh in zip(want[2:], got[2:]):
        assert np.array_equal(gh.numpy(), np.asarray(wh))


@pytest.mark.parametrize("batch", [None, 1, 8])
def test_fused_partitions_segments_and_copies_gaps(rng, batch):
    n = 3000
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    bounds = [(0, 700), (1000, 1300)]       # gaps [700,1000) and [2300,3000)
    nsid = np.where(np.arange(2 * 256) % 7 == 0, 0, 2)
    want, got = _fused_both(rng, x, bounds, n, 256, [0, 8, 8, 8], nsid,
                            a_max=2, r=256, batch=batch)
    _assert_pass_equal(want, got, n)
    assert np.array_equal(_np(got[0], np.uint32)[700:1000], x[700:1000])


@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("lookahead", [False, True])
def test_fused_values_and_next_histograms(rng, batch, lookahead):
    n = 2048
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = (np.arange(n, dtype=np.int32),
            rng.standard_normal(n).astype(np.float64),
            rng.integers(0, 255, n, dtype=np.uint8))
    nsid = np.full(256, 1, np.int32)
    nsid[3] = 0
    want, got = _fused_both(rng, x, [(0, n)], n, 256, [8, 8, 0, 8, 16, 8],
                            nsid, a_max=1, r=256, vals=vals, batch=batch,
                            lookahead=lookahead)
    assert len(got) == (4 if lookahead else 3)
    _assert_pass_equal(want, got, n)


@pytest.mark.parametrize("inert", [1, 4, 64])
@pytest.mark.parametrize("lookahead", [False, True])
def test_fused_inert_rows_between_regions_are_noops(rng, inert, lookahead):
    """Count-0 rows between regions leave the pass as the reference makes
    it."""
    n = 3000
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    nsid = np.where(np.arange(3 * 256) % 5 == 0, 1, 3)
    want, got = _fused_both(rng, x, [(0, 700), (1000, 1300), (2500, 300)],
                            n, 128, [0, 8, 8, 8, 16, 8], nsid, a_max=3,
                            r=256, lookahead=lookahead, inert=inert)
    _assert_pass_equal(want, got, n)


def test_fused_empty_and_partial_segments(rng):
    n = 500
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    want, got = _fused_both(rng, x, [(0, 200), (350, 130)], n, 64,
                            [2, 5, 0, 2], np.full(4 * 32, 4), a_max=4, r=32)
    _assert_pass_equal(want, got, n)


def test_fused_multi_block_carry_with_lookahead(rng):
    """Many blocks per segment (the in-segment carry) and several next-pass
    segments, with the lookahead window, on skewed keys."""
    n = 4000
    x = entropy_keys(rng, n, 2)
    nsid = rng.integers(0, 4, 3 * 64).astype(np.int32)   # 3 == a_max: done
    want, got = _fused_both(rng, x, [(100, 1500), (1700, 2000)], n, 64,
                            [26, 6, 20, 6, 14, 6], nsid, a_max=3, r=64,
                            vals=(np.arange(n, dtype=np.int64),),
                            batch=8, lookahead=True)
    _assert_pass_equal(want, got, n)


# ------------------------------ local sort --------------------------------

@pytest.mark.parametrize("s,l", [(1, 64), (5, 128), (3, 1024)])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.uint8])
def test_bitonic_stable_plain_equals_kernel(rng, s, l, dtype):
    info = np.iinfo(dtype)
    keys = rng.integers(0, min(info.max, 40), (s, l), dtype=dtype)  # ties
    keys[:, -3:] = info.max                    # collisions with the sentinel
    idx = rng.permutation(s * l).astype(np.int32).reshape(s, l)
    with jax.enable_x64(True):
        wk, wi = j_bitonic(jnp.asarray(keys), jnp.asarray(idx),
                           interpret=True)
    gk, gi = bitonic_sort_rows_stable(_t(keys), torch.from_numpy(idx))
    assert _np(gk, dtype).tobytes() == np.asarray(wk).tobytes()
    assert gi.numpy().tobytes() == np.asarray(wi).tobytes()


def _apply(x, src, dst):
    s, d = np.asarray(src), np.asarray(dst)
    out = x.copy()
    m = d < x.shape[0]
    out[d[m]] = x[np.clip(s, 0, x.shape[0] - 1)[m]]
    return out


@pytest.mark.parametrize("use_classes", [False, True])
def test_segmented_local_sort_equals_reference(rng, use_classes):
    n = 4000
    x = rng.integers(0, 50, n, dtype=np.uint32)            # many ties
    x[rng.random(n) < 0.05] = np.uint32(2**32 - 1)        # sentinel-valued
    starts = np.array([0, 3, 40, 41, 300, 1000, 1900, 2900, 3000, 3999],
                      np.int32)
    sizes = np.diff(np.append(starts, n)).astype(np.int32)
    flags = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    row_len = 1024
    classes = (jops.local_sort_class_plan(n, row_len, s_max=len(sizes))
               if use_classes else None)
    assert classes is None or classes == tops.local_sort_class_plan(
        n, row_len, s_max=len(sizes))
    vals = np.arange(n, dtype=np.int32)
    src, dst = jops.segmented_local_sort(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(sizes),
        jnp.asarray(flags), row_len, interpret=True, classes=classes)
    want_k, want_v = _apply(x, src, dst), _apply(vals, src, dst)
    buf = _t(x).clone()
    perm = torch.arange(n, dtype=torch.int32)
    tops.segmented_local_sort(buf, _t(starts), _t(sizes), _t(flags), row_len,
                              classes=classes, perm=perm)
    got_v, = tops.apply_run_copies(perm, (torch.from_numpy(vals),))
    assert _np(buf, np.uint32).tobytes() == want_k.tobytes()
    assert got_v.numpy().tobytes() == want_v.tobytes()


def test_local_sort_class_plan_equals_reference():
    for n, row_len, s_max in [(16384, 1024, 341), (100, 16, 9), (1, 1, 3),
                              (1 << 28, 16384, 208339)]:
        assert tops.local_sort_class_plan(n, row_len, s_max) == \
            jops.local_sort_class_plan(n, row_len, s_max)


# ------------------- host-side sizing of the CUDA kernels -------------------

@pytest.mark.parametrize("address,n,elem,want", [
    (0, 1000, 4, (0, 250, 0)),          # aligned, whole vectors
    (4, 1000, 4, (3, 249, 1)),          # keys[1:] of an aligned buffer
    (12, 1000, 4, (1, 249, 3)),
    (8, 7, 8, (1, 3, 0)),               # int64, odd n
    (0, 7, 8, (0, 3, 1)),
    (1, 100, 1, (15, 5, 5)),            # uint8
    (2, 3, 2, (3, 0, 0)),               # shorter than its head
    (16, 0, 4, (0, 0, 0)),
])
def test_histogram_aligned_split(address, n, elem, want):
    from repro_torch.kernels.histogram import aligned_split
    head, vectors, tail = aligned_split(address, n, elem)
    assert (head, vectors, tail) == want
    assert head + vectors * (16 // elem) + tail == n
    assert head == n or (address + head * elem) % 16 == 0


def test_histogram_aligned_split_refuses_misaligned_elements():
    from repro_torch.kernels.histogram import aligned_split
    with pytest.raises(ValueError, match="element size"):
        aligned_split(2, 10, 4)


@pytest.mark.parametrize("vectors,sms,want", [
    (1 << 26, 132, 528),                # 2^28 uint32 keys on an H100
    (1 << 26, 114, 456),
    (1000, 132, 2),                     # a small input: two vectors a thread
    (1, 132, 1), (0, 132, 1),
])
def test_histogram_total_grid(vectors, sms, want):
    from repro_torch.kernels.histogram import total_grid
    assert total_grid(vectors, sms) == want


@pytest.mark.parametrize("n,word", [(0, 4), ((1 << 30) - 1, 4),
                                    (1 << 30, 8), ((1 << 30) + 7, 8),
                                    ((1 << 31) - 1, 8)])
def test_fused_lookback_word_width(n, word):
    assert tfused.lookback_word_bytes(n) == word
    rows = -(-max(n, 1) // 6912)
    assert tfused.lookback_scratch_bytes(rows, 256, n) == 16 + rows * 256 * word


@pytest.mark.parametrize("r", [4096, 65536])
@pytest.mark.parametrize("n,word", [(1 << 24, 4), ((1 << 30) + 7, 8)])
def test_fused_wide_scratch_layout(r, n, word):
    """The wide variant's scratch: a 16-byte ticket slot, one int flag per
    row (16-byte aligned), r / 32 8-byte bitmap entries per row, one
    look-back word per slot of the padded buffers; only ticket and flags
    are zeroed."""
    kpb = 6912
    length = tfused.pad_length(n, kpb)
    rows = n // kpb + 2 * 1821 + 2
    lay = tfused.wide_scratch_layout(rows, r, length, n)
    flags_end = 16 + (4 * rows + 15) // 16 * 16
    assert lay["flags"] == 16
    assert lay["zeroed"] == lay["bitmap"] == flags_end
    assert lay["words"] == flags_end + rows * r // 32 * 8
    assert lay["words"] % 16 == 0
    assert lay["total"] == flags_end + rows * r // 4 + length * word
    assert tfused.scratch_bytes(rows, r, n, length) == lay["total"]


def test_fused_scratch_bytes_narrow_is_lookback():
    assert tfused.scratch_bytes(100, 512, 1 << 20, 1 << 21) == (
        tfused.lookback_scratch_bytes(100, 512, 1 << 20))
