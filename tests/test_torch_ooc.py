"""``repro_torch.oocsort`` against ``repro.core.outofcore.oocsort``, byte for byte.

Both packages sort the same numpy inputs.  The port runs on the CPU with
its ``argsort`` engine and its ``kernel`` engine (the kernels' plain
versions, the merge round included); the reference runs ``argsort``, which
its own tests pin byte-identical to its kernel engine.  Keys and every value
leaf must be byte-identical and the whole ``OocStats`` equal — with one
field of the kernel engine aside: ``device_high_water_bytes`` charges the
kernel engine's padded ping-pong buffers (``pad_length(n, kpb)``) where the
argsort engine charges n, in both packages, so for the port's kernel engine
it is held to the reference's kernel engine instead
(``test_kernel_engine_ledger_equals_reference``).

Covered: uint32 / int32 / float32 keys (±0, ±inf and NaN payloads) at
n ∈ {0, 1, CHUNK, CHUNK+1, 3·CHUNK+1}; KV, a value pytree, the iterator and
tuple readers; both merge regimes, the 16x-budget spill gate and the
link-byte formula case; ``compress=True``; 64-bit keys (the reference under
``jax.enable_x64``); and the validation errors.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import SortConfig as JConfig  # noqa: E402
from repro.core.outofcore import oocsort as j_oocsort  # noqa: E402
from repro_torch import oocsort  # noqa: E402
from repro_torch.core.interop import (config_from_reference,  # noqa: E402
                                      tree_flatten)
from conftest import entropy_keys  # noqa: E402

CHUNK = 256
TILE = 32
TCFG = JConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)
PCFG = config_from_reference(dataclasses.asdict(TCFG))
SPILL_TILE = 16
SPILL_BUDGET = 4096
KERNEL_LEDGER = "device_high_water_bytes"


def _keys(rng, dtype, n):
    if dtype == np.float32:
        x = (rng.standard_normal(n) * 1e3).astype(dtype)
        if n >= 8:
            x[:4] = [0.0, -0.0, np.inf, -np.inf]
            x[4:8] = np.array([0x7FC00000, 0xFFC00000, 0x7F800001,
                               0xFF812345], np.uint32).view(np.float32)
        return x
    return entropy_keys(rng, n, 1, dtype=np.uint32).astype(dtype)


def _check(reader, chunk, *, engines=("argsort", "kernel"), values=None,
           make_reader=None, **kw):
    """Reference once (argsort), the port once per engine; compare keys,
    value leaves and stats.  ``make_reader`` rebuilds an iterator reader."""
    src = make_reader() if make_reader else reader
    want = j_oocsort(src, chunk, values=values, engine="argsort",
                     cfg=TCFG, return_stats=True, **kw)
    for engine in engines:
        src = make_reader() if make_reader else reader
        got = oocsort(src, chunk, values=values, engine=engine, cfg=PCFG,
                      return_stats=True, device="cpu", **kw)
        assert len(got) == len(want)
        assert isinstance(got[0], np.ndarray)
        assert got[0].dtype == want[0].dtype, engine
        assert got[0].tobytes() == want[0].tobytes(), engine
        if len(want) == 3:
            gl, wl = tree_flatten(got[1])[0], jax.tree.leaves(want[1])
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        gs, ws = got[-1]._asdict(), want[-1]._asdict()
        if engine == "kernel":
            gs.pop(KERNEL_LEDGER)
            ws.pop(KERNEL_LEDGER)
        assert gs == ws, engine
    return want


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("n", [0, 1, CHUNK, CHUNK + 1, 3 * CHUNK + 1])
def test_keys_parity(rng, dtype, n):
    _check(_keys(rng, dtype, n), CHUNK, tile=TILE)


@pytest.mark.parametrize("n", [1, CHUNK + 1, 3 * CHUNK + 1])
def test_kv_parity(rng, n):
    x = entropy_keys(rng, n, 3)                 # heavy duplicates
    _check(x, CHUNK, values=np.arange(n, dtype=np.int32), tile=TILE)


def test_kv_unsigned_values_and_kway(rng):
    n = 4 * CHUNK + 5
    x = _keys(rng, np.float32, n)
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    _check(x, CHUNK, values=v, tile=TILE, kway=3)


def test_value_pytree_parity(rng):
    n = 3 * CHUNK + 7
    x = rng.permutation(n).astype(np.uint32)
    vals = {"a": np.arange(n, dtype=np.int32),
            "b": (np.arange(n, dtype=np.float32) * 2.0,
                  rng.integers(0, 2**16, n, dtype=np.uint16)),
            "c": rng.integers(0, 255, n, dtype=np.uint8)}
    _check(x, CHUNK, values=vals, tile=TILE)


def test_iterator_reader(rng):
    pieces = [rng.integers(0, 2**32, m, dtype=np.uint32)
              for m in (100, 700, 3, 0, 450)]
    _check(None, CHUNK, make_reader=lambda: iter(pieces), tile=TILE)


def test_iterator_tuple_reader(rng):
    pieces, off = [], 0
    for m in (300, 300, 123):
        k = rng.integers(0, 2**32, m, dtype=np.uint32)
        pieces.append((k, np.arange(off, off + m, dtype=np.int32)))
        off += m
    _check(None, CHUNK, make_reader=lambda: iter(pieces), tile=TILE)


def test_stats_and_round_count(rng):
    x = rng.integers(0, 2**32, 8 * CHUNK, dtype=np.uint32)
    st = _check(x, CHUNK, tile=TILE, kway=2, engines=("argsort",))[-1]
    assert st.merge_rounds == 3
    assert st.h2d_bytes == x.nbytes and st.d2h_bytes == x.nbytes


# ---------------- host-spill regime -----------------------------------------

def test_spill_16x_budget_kv(rng):
    """The spill gate: key and value bytes 16x the device budget, the
    modeled high-water mark under it."""
    n = 16 * SPILL_BUDGET // 8
    x = rng.permutation(n).astype(np.uint32)
    st = _check(x, 1 << 20, values=np.arange(n, dtype=np.int32),
                tile=SPILL_TILE, spill_budget_bytes=SPILL_BUDGET,
                engines=("argsort",))[-1]
    assert st.rounds_spilled == st.merge_rounds > 0
    assert st.device_high_water_bytes <= SPILL_BUDGET


@pytest.mark.parametrize("slab", [64, 960])
def test_spill_equals_device_resident(rng, slab):
    x = entropy_keys(rng, 1500, 3)
    v = np.arange(1500, dtype=np.int32)
    _check(x, 300, values=v, tile=TILE, device_slab_elems=slab)
    a = oocsort(x, 300, values=v, tile=TILE, device="cpu")
    b = oocsort(x, 300, values=v, tile=TILE, device_slab_elems=slab,
                device="cpu")
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()


def test_spill_value_pytree(rng):
    n = 6 * 128
    x = rng.permutation(n).astype(np.uint32)
    vals = {"a": np.arange(n, dtype=np.int32),
            "b": np.arange(n, dtype=np.float32) * 2.0}
    _check(x, 128, values=vals, tile=SPILL_TILE, device_slab_elems=64)


def test_spill_link_byte_formula(rng):
    n = 16 * 64
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    v = np.arange(n, dtype=np.int32)
    for values in (None, v):
        st = _check(x, 64, values=values, kway=4, tile=8,
                    device_slab_elems=32)[-1]
        nb = x.nbytes + (0 if values is None else v.nbytes)
        assert st.num_chunks == 16 and st.rounds_spilled == 2
        assert st.chunk_link_bytes == 2 * nb
        assert st.spill_link_bytes == 2 * nb * st.rounds_spilled
        assert st.h2d_bytes + st.d2h_bytes == \
            st.chunk_link_bytes + st.spill_link_bytes + st.retry_link_bytes


def test_spill_leftover_runs(rng):
    x = rng.integers(0, 2**32, 5 * 64, dtype=np.uint32)
    st = _check(x, 64, kway=4, tile=8, device_slab_elems=32)[-1]
    assert st.spill_link_bytes == 2 * (256 * 4) + 2 * (320 * 4)


def test_spill_tight_budget(rng):
    """A budget where the pad tile and the tables rival the slab: the slab
    shrinks until the modeled peak fits, identically in both packages."""
    x = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    st = _check(x, 1 << 20, tile=8, spill_budget_bytes=650,
                engines=("argsort",))[-1]
    assert st.device_high_water_bytes <= 650


def test_kernel_engine_ledger_equals_reference(rng):
    """The kernel engine's padded ping-pong buffers in the budget clamp and
    the ledger, against the reference's kernel engine (interpret mode)."""
    x = rng.integers(0, 2**32, 512, dtype=np.uint32)
    kw = dict(cfg=TCFG, engine="kernel", tile=16, spill_budget_bytes=8192,
              return_stats=True)
    want_k, want_s = j_oocsort(x, 256, **kw)
    got_k, got_s = oocsort(x, 256, **dict(kw, cfg=PCFG), device="cpu")
    assert got_k.tobytes() == want_k.tobytes()
    assert got_s == want_s
    with pytest.raises(ValueError, match="chunk phase"):
        oocsort(x, 256, engine="kernel", tile=16, spill_budget_bytes=4096,
                device="cpu")


# ---------------- compressed keys, 64-bit keys -------------------------------

def test_compress_spill_clustered(rng):
    n = 16 * 64
    c = np.where(np.arange(n) % 8 != 0, 0,
                 rng.integers(1, 4, n)).astype(np.uint32)
    x = (c << np.uint32(12)) | rng.integers(0, 64, n).astype(np.uint32)
    kw = dict(kway=4, tile=8, device_slab_elems=32)
    plain = _check(x, 64, **kw)
    comp = _check(x, 64, compress=True, **kw)
    assert comp[0].tobytes() == plain[0].tobytes() == np.sort(x).tobytes()
    assert comp[-1].chunk_link_bytes == 2 * n * 1     # uint8 carrier


def test_compress_device_resident_kv(rng):
    n = 5 * CHUNK + 3
    x = (rng.integers(0, 1 << 12, n).astype(np.uint64) << np.uint64(8)) | \
        np.uint64(0xA5 << 40)
    _check(x, CHUNK, values=np.arange(n, dtype=np.int32), tile=TILE,
           compress=True)


def test_64bit_keys(rng):
    x = entropy_keys(rng, 3 * CHUNK + 3, 2, dtype=np.uint64)
    v = np.arange(x.size, dtype=np.int64)
    with jax.enable_x64(True):
        _check(x, CHUNK, values=v, tile=TILE)
        _check(x, CHUNK, tile=SPILL_TILE, device_slab_elems=64,
               engines=("argsort",))


# ---------------- validation -------------------------------------------------

def test_validation():
    """Both packages refuse the same bad arguments with the same messages
    (each case builds its reader anew: an iterator is consumed once)."""
    z = np.zeros(4, np.uint32)
    cases = [
        (lambda: dict(reader=z, chunk_elems=0), None),
        (lambda: dict(reader=z, chunk_elems=4, kway=1), None),
        (lambda: dict(reader=np.zeros((2, 2), np.uint32), chunk_elems=4),
         "1-D"),
        (lambda: dict(reader=iter([z]), chunk_elems=4, values=z), None),
        (lambda: dict(reader=iter([]), chunk_elems=4), "empty iterator"),
        (lambda: dict(reader=iter([z, np.zeros(4, np.int32)]),
                      chunk_elems=4), r"chunk 1.*key dtype"),
        (lambda: dict(reader=iter([(z, z), (z, z), (z, (z, z))]),
                      chunk_elems=4), r"chunk 2.*value structure"),
        (lambda: dict(reader=iter([(z, z), (z, np.zeros(3, np.uint32))]),
                      chunk_elems=4), r"chunk 1.*match the key length"),
        (lambda: dict(reader=z, chunk_elems=2,
                      values=np.ones((4, 3), np.float32)), "1-D"),
        (lambda: dict(reader=z, chunk_elems=16, spill_budget_bytes=0),
         "spill_budget_bytes"),
        (lambda: dict(reader=np.zeros(64, np.uint32), chunk_elems=16,
                      tile=32, spill_budget_bytes=100), "too small"),
        (lambda: dict(reader=np.empty(0, np.uint32), chunk_elems=16,
                      tile=32, device_slab_elems=8), "device_slab_elems"),
        (lambda: dict(reader=z, chunk_elems=4, checkpoint_dir="unused"),
         "host-spill"),
    ]
    for make, match in cases:
        for fn in (j_oocsort, lambda **k: oocsort(device="cpu", **k)):
            with pytest.raises(ValueError, match=match):
                fn(**make())


def test_device_rule():
    """A numpy input goes to the GPU unless the caller asks for the CPU;
    without a GPU that raises instead of moving quietly to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oocsort(np.zeros(4, np.uint32), 4)
