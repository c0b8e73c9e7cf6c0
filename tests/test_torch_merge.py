"""The port's merge-path partition and merge round against ``repro.kernels.merge``.

Same numpy runs into both packages, exact comparison:

  * ``merge_path_partition`` tables entry for entry, on the run-length cases
    of ``tests/test_merge_property.py`` (empty, length-1, all-equal,
    sentinel-valued and single-run groups included) and on 64-bit keys;
  * ``host_coranks`` and ``spill_group_plan`` equal to the reference's;
  * ``kway_merge_round_ref`` (what the wrapper runs on a CPU tensor) in
    both rank modes equal to the reference's Pallas kernel in interpret
    mode, keys and values, at tiles 8 to 32.  Slot ``n`` (the trash slot) is
    unspecified in both and left out of the comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.kernels import merge as jmerge  # noqa: E402
from repro.kernels.fused import pad_length  # noqa: E402
from repro_torch.kernels import merge as tmerge  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SENTINEL32 = np.uint32(0xFFFFFFFF)

CASES = [
    (77, 33, 10, 5),
    (64, 64, 64, 64),
    (100, 1),
    (1, 1, 1, 1),
    (0, 50, 0, 3),
    (5,),
    (256, 17, 96),
]


def _t(x):
    """numpy unsigned bits -> the port's carrier (signed twin, same bits)."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.dtype(f"i{x.dtype.itemsize}")).copy())


def _runs(rng, lens, hi=64, dtype=np.uint32):
    return [np.sort(rng.integers(0, hi, n).astype(dtype)) for n in lens]


def _flat(runs, tile, dtype=np.uint32):
    n = sum(len(r) for r in runs)
    pad = pad_length(n, tile) - n
    sentinel = np.iinfo(dtype).max
    return np.concatenate(runs + [np.full(pad, sentinel, dtype)]).astype(
        dtype)


def _tables_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lens", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("kway,tile", [(4, 8), (2, 8), (8, 32)])
def test_partition_tables_equal_reference(rng, lens, kway, tile):
    runs = _runs(rng, lens)
    flat = _flat(runs, tile)
    want = jmerge.merge_path_partition(jnp.asarray(flat), lens, kway, tile)
    got = tmerge.merge_path_partition(_t(flat), lens, kway, tile)
    _tables_equal(got, want)


def test_partition_all_equal_and_sentinel_keys(rng):
    lens = (40, 13, 0, 25)
    for runs in ([np.full(n, 7, np.uint32) for n in lens],
                 [np.sort(np.where(rng.random(n) < 0.5, SENTINEL32,
                                   rng.integers(0, 9, n)).astype(np.uint32))
                  for n in lens]):
        flat = _flat(runs, 8)
        want = jmerge.merge_path_partition(jnp.asarray(flat), lens, 4, 8)
        got = tmerge.merge_path_partition(_t(flat), lens, 4, 8)
        _tables_equal(got, want)


def test_partition_64bit_keys(rng):
    """The top-bit candidate of a 64-bit carrier is -2**63; keys above 2**63
    exercise it."""
    lens = (50, 31, 77)
    runs = [np.sort(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                 endpoint=True)) for n in lens]
    flat = _flat(runs, 16, np.uint64)
    with jax.enable_x64(True):
        want = jmerge.merge_path_partition(jnp.asarray(flat), lens, 4, 16)
        want = [np.asarray(w) for w in want]
    got = tmerge.merge_path_partition(_t(flat), lens, 4, 16)
    _tables_equal(got, want)


@pytest.mark.parametrize("lens", [(77, 33, 10, 5), (0, 50, 0, 3), (1, 200)])
def test_host_coranks_equal_reference(rng, lens):
    runs = _runs(rng, lens, hi=32)
    glen = sum(lens)
    diags = np.minimum(np.arange(0, glen + 7, 7), glen)
    want = jmerge.host_coranks(runs, diags)
    got = tmerge.host_coranks(runs, diags)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("lens", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("tile,slab", [(8, 16), (16, 64)])
def test_spill_group_plan_equal_reference(rng, lens, tile, slab):
    runs = _runs(rng, lens)
    if sum(lens) == 0:
        runs = runs[:2]
    want = jmerge.spill_group_plan(runs, 4, tile, slab)
    got = tmerge.spill_group_plan(runs, 4, tile, slab)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        for a, b in zip(g.tables, w.tables):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_merge_groups_and_rounds():
    for lens in ([5, 4, 3, 2, 1], [1] * 17, []):
        for kway in (2, 3, 4):
            assert tmerge.merge_groups(lens, kway) == \
                jmerge.merge_groups(lens, kway)
            assert tmerge.num_merge_rounds(len(lens), kway) == \
                jmerge.num_merge_rounds(len(lens), kway)


def test_spill_group_plan_validation():
    runs = [np.zeros(4, np.uint32)]
    for slab in (12, 0):
        with pytest.raises(ValueError):
            tmerge.spill_group_plan(runs, 4, 8, slab)


def _round_pair(flat, vals, tables, kway, tile, n, rank):
    """Reference round (interpret mode) and the port's plain round on the
    same buffers and tables."""
    want_k, want_v = jmerge.kway_merge_round(
        jnp.asarray(flat), tuple(jnp.asarray(v) for v in vals),
        jnp.full(flat.shape, np.iinfo(flat.dtype).max, flat.dtype),
        tuple(jnp.zeros_like(jnp.asarray(v)) for v in vals),
        *(jnp.asarray(np.asarray(t)) for t in tables), kway=kway, tpb=tile,
        n=n, interpret=True, rank=rank)
    alt_k = torch.full(flat.shape, -1, dtype=_t(flat[:1]).dtype)
    alt_v = tuple(torch.zeros(v.shape, dtype=_t(v[:1]).dtype) for v in vals)
    got_k, got_v = tmerge.kway_merge_round(
        _t(flat), tuple(_t(v) for v in vals), alt_k, alt_v,
        *(torch.as_tensor(np.array(t)) for t in tables), kway=kway,
        tpb=tile, n=n, rank=rank)
    keep = np.arange(flat.shape[0]) != n            # trash slot unspecified
    assert got_k.numpy().view(flat.dtype)[keep].tobytes() == \
        np.asarray(want_k)[keep].tobytes()
    for g, w, v in zip(got_v, want_v, vals):
        assert g.numpy().view(v.dtype)[keep].tobytes() == \
            np.asarray(w)[keep].tobytes()


@pytest.mark.parametrize("rank", ["searchsorted", "counting"])
@pytest.mark.parametrize("lens,kway,tile", [
    ((77, 33, 10, 5), 4, 8),
    ((64, 64, 64, 64, 64), 4, 16),
    ((0, 50, 0, 3), 4, 8),
    ((100, 1, 40), 2, 32),
    ((40, 13, 25), 4, 16),
])
def test_merge_round_plain_equals_reference(rng, lens, kway, tile, rank):
    runs = _runs(rng, lens, hi=16)
    flat = _flat(runs, tile)
    n = sum(lens)
    vals = (rng.integers(0, 2**31, flat.shape[0]).astype(np.int32),
            rng.integers(0, 2**16, flat.shape[0]).astype(np.uint16))
    tables = jmerge.merge_path_partition(jnp.asarray(flat), lens, kway, tile)
    _round_pair(flat, vals, tables, kway, tile, n, rank)


@pytest.mark.parametrize("rank", ["searchsorted", "counting"])
def test_merge_round_plain_on_spill_strips(rng, rank):
    """The slab contract: strip tables with zero-count padding, ``n`` = the
    slab capacity, keys only and with a value leaf."""
    tile, slab, kway = 8, 32, 4
    runs = _runs(rng, (30, 22, 9), hi=9)
    for strip in jmerge.spill_group_plan(runs, kway, tile, slab):
        wins = [r[lo:lo + ln] for r, lo, ln in
                zip(runs, strip.win_lo, strip.win_len)]
        buf = np.concatenate(wins + [np.full(
            pad_length(slab, tile) - strip.out_len, SENTINEL32, np.uint32)])
        vals = (np.arange(buf.shape[0], dtype=np.int32),)
        _round_pair(buf, (), strip.tables, kway, tile, slab, rank)
        _round_pair(buf, vals, strip.tables, kway, tile, slab, rank)


def test_merge_round_rejects_unknown_rank():
    z = torch.zeros(16, dtype=torch.int32)
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rank"):
        tmerge.kway_merge_round(z, (), z.clone(), (), t, t, t.repeat(2),
                                t.repeat(2), kway=2, tpb=8, n=8, rank="x")
    with pytest.raises(ValueError, match="rank"):
        ref.kway_merge_round_ref(z, (), z.clone(), (), t, t, t.repeat(2),
                                 t.repeat(2), kway=2, tpb=8, n=8, rank="x")


def test_smem_limit_message():
    assert tmerge.smem_bytes(4, 4096, 4) < tmerge.SMEM_LIMIT
    assert tmerge.smem_bytes(8, 4096, 8) > tmerge.SMEM_LIMIT
