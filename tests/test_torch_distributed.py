"""The port's distributed sample sort (``repro_torch.core.distributed``)
against the reference's (``repro.core.distributed``), on the CPU.

* Unit parity in this process: ``_select_splitters``, ``_even_sample_ranks``
  and ``_dest_shards`` on the same numpy inputs.
* The host-replay properties of ``tests/test_distributed_property.py`` on the
  port's functions: monotone splitters, exactly-once routing, tie-cycling
  balance, clustered skew ≤ 2x.
* Whole-sort parity: the reference runs under ``shard_map`` in a fresh
  interpreter with P fake host devices (``tests/_multidev.py``; one
  subprocess per P, both started at once) and writes its outputs to an
  ``.npz``; the port runs ``LocalMesh(P, "cpu")`` on the same inputs.  The
  full padded key output and every value leaf must be equal byte for byte,
  and every ``DistStats`` field equal.
* Two spawned gloo ranks (``ProcessGroupMesh``) against ``LocalMesh(2)``.
* The launch census on the CPU's kernel engine (the kernels' plain
  versions), counted at the wrapper calls.
"""
import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from _multidev import run_multidev  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.model import SortConfig as JConfig  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.core.bijection import to_ordered_bits_np  # noqa: E402
from repro_torch.core.distributed import (DistStats, LocalMesh,  # noqa: E402
                                          ProcessGroupMesh,
                                          make_distributed_sort,
                                          valid_concat)
from repro_torch.core.interop import config_from_reference  # noqa: E402
from repro_torch.data.distributions import (clustered_keys,  # noqa: E402
                                            zipf_keys)
from repro_torch.kernels import fused  # noqa: E402

#: the small config of the verify notes: counting passes, R3 merges and the
#: local sort all run on shards of a few thousand keys
TCFG = dict(d=8, kpb=64, local_threshold=48, merge_threshold=32)
NSHARDS = 8
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _carrier(x: np.ndarray) -> torch.Tensor:
    """Unsigned ordered bits as the port's signed carrier."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(x.dtype.str.replace("u", "i")))


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(_UINT[a.dtype.itemsize])


# --------------------------------------------------------------------------
# unit parity
# --------------------------------------------------------------------------

SPLITTER_CASES = {
    "empty": (np.zeros(0, np.uint32), 8),
    "one": (np.full(1, 5, np.uint32), 8),
    "three": (np.arange(5, 8, dtype=np.uint32), 8),
    "regular": (np.arange(64, dtype=np.uint32), 8),
    "non_multiple": (np.arange(15, dtype=np.uint32), 8),
    "single_shard": (np.arange(9, dtype=np.uint32), 1),
    "top_bit": (np.sort(np.random.default_rng(5).integers(
        0, 2**32, 1000, dtype=np.uint32)), 8),
    "uint16": (np.sort(np.random.default_rng(6).integers(
        0, 2**16, 77, dtype=np.uint16)), 5),
}


@pytest.mark.parametrize("oversample", [1, 8])
@pytest.mark.parametrize("case", sorted(SPLITTER_CASES))
def test_select_splitters_equal_reference(case, oversample):
    x, nshards = SPLITTER_CASES[case]
    want = np.asarray(jdist._select_splitters(jnp.asarray(x), nshards,
                                              oversample=oversample))
    got = tdist._select_splitters(_carrier(x), nshards, oversample)
    assert got.shape == want.shape == (nshards - 1,)
    assert np.array_equal(_bits(got), want.astype(x.dtype))


@pytest.mark.parametrize("n,m", [(1, 1), (7, 3), (2048, 512), (100, 100),
                                 (5, 64)])
def test_even_sample_ranks_equal_reference(n, m):
    want = np.asarray(jdist._even_sample_ranks(n, m))
    got = tdist._even_sample_ranks(n, m).numpy()
    assert np.array_equal(got, want)


def _dest_inputs(name):
    rng = np.random.default_rng(17)
    n = 3000
    if name == "uniform":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif name == "dups":
        x = rng.integers(0, 5, n).astype(np.uint32) * np.uint32(0x40000000)
    elif name == "constant":
        x = np.full(n, 0xFFFFFFFF, np.uint32)
    else:
        x = rng.integers(0, 2**16, n, dtype=np.uint16)
    x = np.sort(x)
    spl = np.sort(x[rng.integers(0, n, NSHARDS - 1)])
    return x, spl


@pytest.mark.parametrize("my", [0, 3, 7])
@pytest.mark.parametrize("name", ["uniform", "dups", "constant", "uint16"])
def test_dest_shards_equal_reference(name, my):
    x, spl = _dest_inputs(name)
    want = np.asarray(jdist._dest_shards(jnp.asarray(x), jnp.asarray(spl),
                                         NSHARDS, my))
    got = tdist._dest_shards(_carrier(x), _carrier(spl), NSHARDS, my)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_dest_shards_single_shard():
    x = np.sort(np.random.default_rng(2).integers(0, 9, 50).astype(
        np.uint32))
    got = tdist._dest_shards(_carrier(x), _carrier(x[:0]), 1, 0)
    assert np.array_equal(got.numpy(), np.zeros(50, np.int32))


# --------------------------------------------------------------------------
# host-replay properties (tests/test_distributed_property.py on the port)
# --------------------------------------------------------------------------

def _splitters(x: np.ndarray, nshards: int, oversample: int = 64):
    """Host replay of the per-shard sample -> global splitter path."""
    shards = [np.sort(s) for s in x.reshape(nshards, -1)]
    chunk = shards[0].shape[0]
    m = max(1, min(nshards * oversample, chunk))
    ranks = tdist._even_sample_ranks(chunk, m).numpy()
    gsample = np.sort(np.concatenate([s[ranks] for s in shards]))
    return shards, _bits(tdist._select_splitters(_carrier(gsample), nshards))


def _route(x: np.ndarray, nshards: int, oversample: int = 64):
    """(sorted shards, per-shard dests, per-dest loads, max (src,dst) load)."""
    shards, spl = _splitters(x, nshards, oversample)
    dests, loads, pair = [], np.zeros(nshards, np.int64), 0
    for my, s in enumerate(shards):
        d = tdist._dest_shards(_carrier(s), _carrier(spl), nshards,
                               my).numpy()
        dests.append(d)
        c = np.bincount(d, minlength=nshards)
        loads += c
        pair = max(pair, int(c.max()))
    return shards, dests, loads, pair


def _dup_heavy_cases(n):
    rng = np.random.default_rng(3)
    return {
        "all-equal": np.full(n, 7, np.uint32),
        "two-value": rng.choice(np.array([5, 9], np.uint32), n),
        "zipf-1.5": zipf_keys(3, n, a=1.5),
        "clustered": clustered_keys(3, n, clusters=4),
    }


def test_splitters_monotone_deterministic():
    n = NSHARDS * 1900
    cases = _dup_heavy_cases(n)
    cases["uniform"] = np.random.default_rng(0).integers(
        0, 2**32 - 1, n, dtype=np.uint32, endpoint=True)
    for name, x in cases.items():
        _, spl = _splitters(x, NSHARDS)
        assert np.all(np.diff(spl.astype(np.int64)) >= 0), name
        assert spl.shape == (NSHARDS - 1,), name
        again = _splitters(x, NSHARDS)[1]
        assert np.array_equal(spl, again), name


def test_exactly_once_routing():
    n = NSHARDS * 1900
    for name, x in _dup_heavy_cases(n).items():
        shards, dests, loads, _ = _route(x, NSHARDS)
        assert loads.sum() == n, name
        routed = np.concatenate(
            [s[d == k] for k in range(NSHARDS)
             for s, d in zip(shards, dests)])
        assert np.array_equal(np.sort(routed), np.sort(x)), name


def test_tie_cycling_balance_duplicate_heavy():
    n = NSHARDS * 1900
    chunk = n // NSHARDS
    for name, x in _dup_heavy_cases(n).items():
        _, _, loads, pair = _route(x, NSHARDS)
        assert loads.max() <= 2.0 * (n / NSHARDS), (name, loads)
        assert pair <= 2 * -(-chunk // NSHARDS), (name, pair)


@pytest.mark.parametrize("nshards", [2, 8])
def test_clustered_skew_le_2x(nshards):
    for n_local in (1900, 1000):
        for seed in range(2):
            x = clustered_keys(seed, nshards * n_local, clusters=4)
            _, _, loads, _ = _route(x, nshards)
            assert loads.max() <= 2.0 * x.size / nshards, (n_local, seed,
                                                           loads)


# --------------------------------------------------------------------------
# whole-sort parity against the reference's shard_map sort
# --------------------------------------------------------------------------

#: (name, dtype, keys kind, values, knobs, small config, P values): every
#: case runs with the small config's passes unless it says otherwise
CASES = [
    ("uint32", "uint32", "uniform", False, {}, True, (2, 8)),
    ("uint32_default_cfg", "uint32", "uniform", False, {}, False, (2, 8)),
    ("int32", "int32", "uniform", False, {}, True, (2, 8)),
    ("float32_special", "float32", "special", True, {}, True, (2, 8)),
    ("int16", "int16", "uniform", False, {}, True, (2, 8)),
    ("kv_chunks2", "uint32", "uniform", True, {"num_chunks": 2}, True,
     (2, 8)),
    ("constant", "uint32", "constant", True, {}, True, (2, 8)),
    ("degenerate", "uint32", "tiny", True, {"num_chunks": 4}, True, (2, 8)),
    ("retry_converges", "uint32", "retry", False,
     {"oversample": 2, "slack": 1.2, "max_attempts": 3}, False, (8,)),
    ("retry_exhausts", "uint32", "retry", False,
     {"oversample": 2, "slack": 0.5, "max_attempts": 3}, False, (8,)),
]
N_LOCAL = 1 << 10


def _case_input(kind, dtype, nshards):
    """The same keys for both packages, from a seed."""
    rng = np.random.default_rng(
        [nshards, zlib.crc32(f"{kind}/{dtype}".encode())])
    dtype = np.dtype(dtype)
    n = nshards * N_LOCAL
    if kind == "uniform":
        if dtype.kind == "f":
            return rng.standard_normal(n).astype(dtype)
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, dtype=dtype,
                            endpoint=True)
    if kind == "special":
        pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                         1.5, -1.5], dtype)
        x = pool[rng.integers(0, pool.size, n)]
        # NaN payloads must survive the byte exchange bit for bit
        bits = x.view(np.uint32)
        nan = np.isnan(x)
        bits[nan] |= rng.integers(1, 1 << 22, int(nan.sum()),
                                  dtype=np.uint32)
        return x
    if kind == "constant":
        return np.full(n, 42, dtype)
    if kind == "tiny":                       # n_local = 1 < num_chunks
        return rng.integers(0, 2**32, nshards, dtype=np.uint32)
    # the reference's adversarial retry input (RETRY_BODY)
    rng = np.random.default_rng(7)
    n = nshards * (1 << 12)
    base = rng.integers(0, 2**32 - 1, n, dtype=np.uint32, endpoint=True)
    cl = (0x80000000 + rng.integers(0, 1 << 16, n, dtype=np.uint32))
    return np.where(rng.random(n) < 0.95, cl, base).astype(np.uint32)


REFERENCE_BODY = """
import json
from repro.core.model import SortConfig
spec = json.load(open({spec!r}))
inp = np.load({inputs!r})
out = {{}}
for name, values, knobs, small in spec:
    cfg = SortConfig(**{tcfg!r}) if small else None
    fn = jax.jit(make_distributed_sort(mesh, "data", cfg=cfg,
                                       engine="argsort", **knobs))
    x = jnp.asarray(inp[name])
    if values:
        k, v, st = fn(x, jnp.asarray(np.arange(x.shape[0], dtype=np.int32)))
        out[name + "/v"] = np.asarray(v)
    else:
        k, st = fn(x)
    out[name + "/k"] = np.asarray(k)
    for f in DistStats._fields:
        out[name + "/" + f] = np.asarray(getattr(st, f))
np.savez({outputs!r}, **out)
"""


def _reference_outputs(tmp, nshards):
    cases = [c for c in CASES if nshards in c[6]]
    inputs = {c[0]: _case_input(c[2], c[1], nshards) for c in cases}
    spec = [(c[0], c[3], c[4], c[5]) for c in cases]
    paths = {k: os.path.join(tmp, f"{k}_{nshards}.{ext}") for k, ext in
             (("spec", "json"), ("inputs", "npz"), ("outputs", "npz"))}
    with open(paths["spec"], "w") as f:
        json.dump(spec, f)
    np.savez(paths["inputs"], **inputs)
    run_multidev(REFERENCE_BODY.format(tcfg=TCFG, **paths), ndev=nshards,
                 timeout=600)
    return inputs, dict(np.load(paths["outputs"]))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every case at P = 2 and P = 8, from two
    subprocesses run at once."""
    tmp = str(tmp_path_factory.mktemp("dist_reference"))
    with ThreadPoolExecutor(2) as pool:
        futs = {p: pool.submit(_reference_outputs, tmp, p) for p in (2, 8)}
        return {p: f.result() for p, f in futs.items()}


def _port_run(x, nshards, values, knobs, small, engine=None, mesh=None):
    """The port's sort of ``x`` (with ``values`` True: its global index as
    the value; or a given value array), as (keys, values or None, stats)."""
    cfg = (config_from_reference(dict(TCFG)) if small else None)
    fn = make_distributed_sort(mesh or LocalMesh(nshards, "cpu"), cfg=cfg,
                               engine=engine, **knobs)
    if values is True:
        values = np.arange(x.shape[0], dtype=np.int32)
    if values is not None and values is not False:
        return fn(x, values)
    k, st = fn(x)
    return k, None, st


def _assert_equal_to_reference(got, ref, name):
    k, v, st = got
    assert k.numpy().dtype == ref[name + "/k"].dtype
    assert np.array_equal(_bits(k), _bits(ref[name + "/k"])), name
    if v is not None:
        assert np.array_equal(v.numpy(), ref[name + "/v"]), name
    for f in DistStats._fields:
        want = ref[name + "/" + f]
        have = getattr(st, f).numpy()
        assert have.dtype == want.dtype and np.array_equal(have, want), (
            name, f, have, want)


@pytest.mark.parametrize("nshards,case", [
    (p, c[0]) for p in (2, 8) for c in CASES if p in c[6]])
def test_distributed_sort_equals_reference(reference, nshards, case):
    _, dtype, kind, values, knobs, small, _ = next(
        c for c in CASES if c[0] == case)
    inputs, ref = reference[nshards]
    x = inputs[case]
    got = _port_run(x, nshards, values, knobs, small)
    _assert_equal_to_reference(got, ref, case)
    k, v, st = got
    if case == "retry_converges":
        assert int(st.exchange_attempts[0]) > 1
        assert not st.overflow.any()
    if case == "retry_exhausts":
        assert int(st.exchange_attempts[0]) == 3 and st.overflow.all()
        assert int(st.valid.sum()) < x.size
    if case != "degenerate" and not st.overflow.any():
        keys = valid_concat(k, st.valid).numpy()
        order = np.argsort(to_ordered_bits_np(x), kind="stable")
        assert np.array_equal(_bits(keys), _bits(x[order]))
        if v is not None:                # a permutation pairing each key
            gv = valid_concat(v, st.valid).numpy()
            assert np.array_equal(np.sort(gv), np.arange(x.size))
            assert np.array_equal(_bits(x[gv]), _bits(keys))


@pytest.mark.parametrize("case", ["kv_chunks2", "int16", "float32_special",
                                  "retry_converges"])
def test_kernel_engine_equals_reference(reference, case):
    """The port's kernel engine (the kernels' plain versions on the CPU)
    gives the reference's bytes too."""
    _, dtype, kind, values, knobs, small, ps = next(
        c for c in CASES if c[0] == case)
    nshards = ps[-1]
    inputs, ref = reference[nshards]
    got = _port_run(inputs[case], nshards, values, knobs, small,
                    engine="kernel")
    _assert_equal_to_reference(got, ref, case)


def test_value_pytree_and_errors():
    x = np.random.default_rng(4).integers(0, 2**32, 2 * 512, dtype=np.uint32)
    vals = {"a": np.arange(x.size, dtype=np.uint32),
            "b": (np.arange(x.size, dtype=np.float64) * 0.5,)}
    fn = make_distributed_sort(LocalMesh(2, "cpu"))
    k, v, st = fn(x, vals)
    keys = valid_concat(k, st.valid).numpy()
    a = valid_concat(v["a"], st.valid).numpy()
    assert v["a"].dtype == torch.uint32 and isinstance(v["b"], tuple)
    assert np.array_equal(keys, np.sort(x)) and np.array_equal(x[a], keys)
    assert np.array_equal(valid_concat(v["b"][0], st.valid).numpy(), a * 0.5)
    with pytest.raises(ValueError, match="payload leaf length"):
        fn(x, np.arange(5))
    with pytest.raises(ValueError, match="num_chunks"):
        make_distributed_sort(LocalMesh(2, "cpu"), num_chunks=3)(x)
    with pytest.raises(ValueError, match="max_attempts"):
        make_distributed_sort(LocalMesh(2, "cpu"), max_attempts=0)
    with pytest.raises(ValueError, match="split into"):
        fn(x[:-1])
    with pytest.raises(ValueError, match="mesh runs on"):
        fn(torch.from_numpy(x).to("meta"))


def test_valid_concat_numpy_and_tensor():
    out = np.arange(12).reshape(3, 4)
    want = np.array([0, 1, 4, 8, 9, 10, 11])
    assert np.array_equal(valid_concat(out, [2, 1, 4]), want)
    assert np.array_equal(jdist.valid_concat(out, np.array([2, 1, 4])), want)
    got = valid_concat(torch.from_numpy(out), torch.tensor([2, 1, 4]))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(),
                                                            want)


def test_local_mesh_collectives():
    mesh = LocalMesh(3, "cpu")
    blocks = [torch.arange(6, dtype=torch.int16).reshape(3, 2) + 10 * i
              for i in range(3)]
    got = mesh.all_to_all(blocks)
    for j in range(3):
        assert torch.equal(got[j], torch.stack([b[j] for b in blocks]))
    rows = [torch.tensor([i, -i], dtype=torch.int64) for i in range(3)]
    assert torch.equal(mesh.all_gather(rows), torch.stack(rows))
    flags = [torch.tensor(False), torch.tensor(True), torch.tensor(False)]
    assert bool(mesh.any(flags)) and not bool(mesh.any(flags[::2]))
    with pytest.raises(ValueError):
        LocalMesh(0, "cpu")


# --------------------------------------------------------------------------
# the census on the CPU's kernel engine
# --------------------------------------------------------------------------

def test_kernel_engine_census_on_cpu(monkeypatch):
    """Per shard: C·(1 + A) + 1 prologue histograms, the chunk sorts'
    executed passes + C·A + 1 fused passes, at most C·classes local sorts
    (counted at the wrapper calls); the reference's static total at the
    same (P, C, A) bounds it."""
    from repro.analysis import contracts
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
    pcfg = config_from_reference(dict(TCFG))
    nshards, n_local = 2, 2048
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, nshards * n_local, dtype=np.uint32)
    retry = _case_input("retry", "uint32", 8)
    cases = [(x, 2, 1, {}), (x, 2, 2, {}),
             (retry, 8, 1, dict(oversample=2, slack=1.2))]
    for keys, p, chunks, knobs in cases:
        nl = keys.size // p
        chunk = nl // chunks
        passes = 0
        for c in range(p * chunks):
            _, st = thybrid.hybrid_sort(keys[c * chunk:(c + 1) * chunk],
                                        cfg=pcfg, engine="kernel",
                                        return_stats=True, narrow=False,
                                        device="cpu")
            passes += st.counting_passes
        for key in calls:
            calls[key] = 0
        _, st = make_distributed_sort(LocalMesh(p, "cpu"), cfg=pcfg,
                                      engine="kernel", num_chunks=chunks,
                                      **knobs)(keys)
        attempts = int(st.exchange_attempts[0])
        assert attempts == 1 or knobs
        classes = len(thybrid.local_sort_classes(chunk, pcfg))
        assert calls["hist"] == p * (chunks * (1 + attempts) + 1)
        assert calls["pass"] == passes + p * (chunks * attempts + 1)
        assert calls["local"] <= p * chunks * classes
        # the reference's static total less its chunk sorts' share
        # (chunks · (2 + classes)) is the exchanges' and the compaction's
        # launches: the port's, per shard, beyond the chunk sorts' own
        static = contracts.expected_census(
            "distributed_shard", contracts.dist_params(
                p, nl, chunks, attempts, JConfig(**TCFG)))["total"]
        exchange = calls["hist"] + calls["pass"] - p * chunks - passes
        assert exchange == p * (static - chunks * (2 + classes))
    assert attempts > 1


# --------------------------------------------------------------------------
# two gloo ranks against the local mesh
# --------------------------------------------------------------------------

GLOO_CASES = [("kv_chunks2", "uint32", "uniform", True, {"num_chunks": 2}),
              ("int16", "int16", "uniform", True, {}),
              ("float32_special", "float32", "special", False, {})]


def _gloo_rank(rank, store, tmp):
    """One spawned rank: sort its shard of every case over a gloo
    ``ProcessGroupMesh`` and save the outputs."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import length_bucketed_batches
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        mesh = ProcessGroupMesh(device="cpu")
        out = {}
        for name, dtype, kind, values, knobs in GLOO_CASES:
            x = _case_input(kind, dtype, 2)
            idx = np.arange(x.size, dtype=np.int32).reshape(2, -1)[rank]
            k, v, st = _port_run(x.reshape(2, -1)[rank], 2,
                                 idx if values else None, knobs, True,
                                 mesh=mesh, engine="kernel")
            out[name + "/k"] = k.numpy()
            if v is not None:
                out[name + "/v"] = v.numpy()
            for f in DistStats._fields:
                out[name + "/" + f] = getattr(st, f).numpy()
        order, bounds = length_bucketed_batches(_doc_lengths(999), 4096,
                                                dist_mesh=mesh)
        out["bucket/order"] = order
        out["bucket/bounds"] = np.asarray(bounds)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _doc_lengths(n):
    return np.random.default_rng(31).integers(1, 3000, n).astype(np.uint32)


def test_gloo_ranks_equal_local_mesh(tmp_path):
    import torch.multiprocessing as mp
    from repro_torch.data.pipeline import length_bucketed_batches
    mp.spawn(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for name, dtype, kind, values, knobs in GLOO_CASES:
        x = _case_input(kind, dtype, 2)
        k, v, st = _port_run(x, 2, values, knobs, True, engine="kernel")
        got_k = np.concatenate([r[name + "/k"] for r in ranks])
        assert np.array_equal(_bits(got_k), _bits(k)), name
        if v is not None:
            got_v = np.concatenate([r[name + "/v"] for r in ranks])
            assert np.array_equal(got_v, v.numpy()), name
        for f in DistStats._fields:
            got = np.concatenate([r[name + "/" + f] for r in ranks])
            assert np.array_equal(got, getattr(st, f).numpy()), (name, f)
    order, bounds = length_bucketed_batches(_doc_lengths(999), 4096,
                                            dist_mesh=LocalMesh(2, "cpu"))
    for r in ranks:
        assert np.array_equal(r["bucket/order"], order)
        assert r["bucket/bounds"].tolist() == bounds


def test_process_group_mesh_device_rules(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="device='cpu'"):
            ProcessGroupMesh()
        with pytest.raises(ValueError, match="CPU tensors only"):
            ProcessGroupMesh(device="cuda")
        mesh = ProcessGroupMesh(device="cpu")
        assert mesh.size == 1 and mesh.shards == (0,)
        with pytest.raises(ValueError, match="given a tensor on meta"):
            mesh.all_to_all([torch.zeros((1, 3), device="meta")])
        x = np.random.default_rng(8).integers(0, 2**32, 3000,
                                              dtype=np.uint32)
        got = _port_run(x, 1, True, {}, True, mesh=mesh)
        want = _port_run(x, 1, True, {}, True)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
        for f in DistStats._fields:
            assert torch.equal(getattr(got[2], f), getattr(want[2], f))
    finally:
        dist.destroy_process_group()
