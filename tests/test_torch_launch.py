"""Slice S6c of the port — the production mesh, the name-based sharding
rules, the collective counter, the roofline, ``compressed_psum`` and the
dry run — held to the reference ``repro`` on the CPU.

* ``param_spec`` / ``_spec_like`` for every leaf of the ten full configs
  (the port's shapes-only parameters against ``jax.eval_shape`` of the
  reference's), ``batch_specs`` and ``cache_specs``, on the reference
  tests' three meshes: the port's spec is the reference's without the
  leading ``None`` of a stacked leaf.
* Each leaf's local shard on a fake (16, 16) process group is the shard
  the reference's spec implies.
* The roofline's terms with the H100 constants; ``model_flops`` equal to
  the reference's for every arch x shape; one case per wire factor.
* ``compressed_psum`` over 4 spawned gloo ranks against the reference's
  under ``shard_map`` (4 host devices, in a subprocess).
* A smoke model's train step on a (1, 1) gloo mesh with DTensor parameters
  bit-equal to the plain step; two spawned gloo ranks at (2, 1) and (1, 2)
  within a float32 tolerance.
* The dry run of three smoke configs (dense, MoE, hybrid) on a fake (2, 2)
  mesh at small shapes: every cell ``ok``, its argument bytes per chip the
  reference ``lower_cell``'s.
"""
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402
from repro_torch.utils.collectives import (CollectiveMode,  # noqa: E402
                                           collective_bytes,
                                           collective_counts, wire_bytes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class DataMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class OddMesh:
    shape = {"data": 16, "model": 7}          # model=7: head dims don't divide
    axis_names = ("data", "model")


class PodMesh:
    shape = {"pod": 2, "data": 8, "model": 7}
    axis_names = ("pod", "data", "model")


MESHES = {"16x16": DataMesh, "16x7": OddMesh, "2x8x7": PodMesh}
_STACK = re.compile(r"\['layers'\]\[\d+\]")


def _ref_cfg(arch):
    from repro.configs import get_config as ref_get
    return ref_get(arch)


_REF_TREES = {}


def _ref_params(arch):
    """The reference's full-config parameter tree of shapes
    (``jax.eval_shape``: nothing is drawn)."""
    if arch not in _REF_TREES:
        from repro.models import init_params
        cfg = _ref_cfg(arch)
        _REF_TREES[arch] = jax.eval_shape(
            lambda: init_params(cfg, jax.random.PRNGKey(0)))
    return _REF_TREES[arch]


def _by_path(tree):
    """{key string: leaf} of a reference tree."""
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_params(arch):
    from repro_torch.models import init_params
    return init_params(get_config(arch), device="meta")


# --------------------------------------------------------------------------
# the sharding rules, leaf for leaf, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mesh_name):
    """Every leaf of the full config: ``param_spec`` on the port's path and
    shape is the reference's spec of the stacked leaf without its leading
    None, and the fallback-checked ``_spec_like`` equals the reference's."""
    from repro.launch import sharding as rs
    mesh = MESHES[mesh_name]()
    tree = _ref_params(arch)
    ref = {k: tuple(v.shape) for k, v in _by_path(tree).items()}
    rcfg, cfg = _ref_cfg(arch), get_config(arch)
    params = _port_params(arch)
    ref_like = {k: tuple(v) for k, v in _by_path(
        rs._spec_like(tree, rcfg, mesh)).items()}
    port_like = dict(shd.leaves_with_paths(shd._spec_like(params, cfg,
                                                          mesh)))
    leaves = shd.leaves_with_paths(params)
    seen = set()
    for path, leaf in leaves:
        rpath = _STACK.sub("['layers']", path)
        stacked = rpath != path
        rshape = ref[rpath]
        assert tuple(leaf.shape) == (rshape[1:] if stacked else rshape), path
        want = tuple(rs.param_spec(rpath, rshape, rcfg, mesh))
        got = shd.param_spec(path, tuple(leaf.shape), cfg, mesh)
        assert tuple(got) == (want[1:] if stacked else want), (path, got,
                                                               want)
        want_like = ref_like[rpath]
        if stacked and len(want_like):
            want_like = want_like[1:]
        assert tuple(port_like[path]) == want_like, (path, port_like[path],
                                                     want_like)
        seen.add(rpath)
    assert seen == set(ref), set(ref) ^ seen


def test_param_spec_normalizes_single_axis_tuples():
    """The counterpart of the reference's test of the same name, on the
    port's per-layer leaves."""
    cfg = get_config("deepseek_67b")
    mesh = OddMesh()
    for w in ("wq", "wk", "wv"):
        spec = shd.param_spec(f"['layers'][0]['attn']['{w}']", (8192, 1024),
                              cfg, mesh)
        assert spec == shd.P("data", None), w
    assert shd.param_spec("['layers'][0]['attn']['wo']", (8192, 8192), cfg,
                          mesh) == shd.P(None, "data")
    assert shd.param_spec("['layers'][3]['mlp']['w_gate']", (8192, 22016),
                          cfg, mesh) == shd.P("data", None)
    assert shd.param_spec("['layers'][3]['mlp']['w_down']", (22016, 8192),
                          cfg, mesh) == shd.P(None, "data")
    moe = get_config("qwen3_moe_30b_a3b")
    assert shd.param_spec("['layers'][0]['moe']['w_gate']", (3, 2048, 768),
                          moe, mesh) == shd.P(None, "data", None)
    spec = shd.param_spec("['layers'][0]['attn']['wk']", (8192, 1024), cfg,
                          PodMesh())
    assert spec == shd.P(("pod", "data"), None)
    assert shd._norm_axis(("data",)) == "data"
    assert shd._norm_axis(("pod", "data")) == ("pod", "data")
    assert shd._norm_axis(()) is None and shd._norm_axis(None) is None


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_match_reference(mesh_name):
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.launch import sharding as rs
    mesh = MESHES[mesh_name]()
    for arch in ARCHS:
        rcfg, cfg = _ref_cfg(arch), get_config(arch)
        for name in SHAPES:
            want = {k: tuple(v) for k, v in rs.batch_specs(
                rcfg, mesh, REF_SHAPES[name]).items()}
            got = {k: tuple(v) for k, v in shd.batch_specs(
                cfg, mesh, SHAPES[name]).items()}
            assert got == want, (arch, name)
            b, s = SHAPES[name].global_batch, SHAPES[name].seq_len
            rc, pc = rs.cache_specs(rcfg, mesh, b, s), shd.cache_specs(
                cfg, mesh, b, s)
            for f in ("kv_k", "kv_v", "ssm_state", "ssm_conv"):
                r, p = getattr(rc, f), getattr(pc, f)
                assert (r is None) == (p is None), (arch, name, f)
                if r is not None:
                    assert tuple(p) == tuple(r)[1:], (arch, name, f, p, r)
            assert tuple(rc.length) == () and pc.length is None


# --------------------------------------------------------------------------
# local shards on a fake 256-rank group
# --------------------------------------------------------------------------

@pytest.fixture
def fake_group():
    """A fake default process group (rank 0); closed after the test."""
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    def open_(n):
        M.close_group()
        M.open_fake_group(n)
    yield open_
    M.close_group()


def _implied(shape, spec, sizes):
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_on_fake_16x16_group(arch, fake_group):
    from repro.launch import sharding as rs
    fake_group(256)
    mesh = M.make_production_mesh(device_type="cpu")
    assert M.axis_sizes(mesh) == {"data": 16, "model": 16}
    assert M.data_shards(mesh) == 16 and M.model_shards(mesh) == 16
    tree = _ref_params(arch)
    ref = {k: tuple(v.shape) for k, v in _by_path(tree).items()}
    rcfg, cfg = _ref_cfg(arch), get_config(arch)
    params = _port_params(arch)
    placed = shd.distribute(params, shd.param_shardings(params, cfg, mesh),
                            mesh)
    ref_like = _by_path(rs._spec_like(tree, rcfg, DataMesh()))
    for path, t in shd.leaves_with_paths(placed):
        rpath = _STACK.sub("['layers']", path)
        want = _implied(ref[rpath], ref_like[rpath], DataMesh.shape)
        if rpath != path:
            want = want[1:]
        assert tuple(t.to_local().shape) == want, (path, t.placements)


def test_to_placements_major_first(fake_group):
    from torch.distributed.tensor import Replicate, Shard
    fake_group(512)
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    assert M.data_axes(mesh) == ("pod", "data") and M.data_shards(mesh) == 32
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(shd.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="major-to-minor"):
        shd.to_placements(shd.P(("data", "pod")), mesh)
    t = torch.empty(64, 4, device="meta")
    d = shd.distribute(t, shd.to_placements(shd.P(("pod", "data")), mesh),
                       mesh)
    assert tuple(d.to_local().shape) == (2, 4)


# --------------------------------------------------------------------------
# roofline and model FLOPs
# --------------------------------------------------------------------------

def test_roofline_terms():
    r = RL.Roofline(arch="a", shape="s", step="train", mesh="pod", chips=256,
                    flops_per_chip=989e12, hbm_bytes_per_chip=3.35e12,
                    coll_bytes_per_chip=50e9,
                    model_flops_global=989e12 * 256, mem_per_chip=79e9)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.fits and abs(r.useful_flops_fraction - 1.0) < 1e-9
    assert abs(r.mfu_bound - 1.0) < 1e-9 and r.t_bound == r.t_compute
    row = r.row()
    assert row["fits_80gb"] is True and "fits_16gib" not in row
    assert not dataclasses.replace(r, mem_per_chip=81e9).fits
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW, RL.HBM_CAP) == (
        989e12, 3.35e12, 50e9, 80e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.utils.roofline import model_flops as ref_flops
    for name in SHAPES:
        assert RL.model_flops(get_config(arch), SHAPES[name]) == ref_flops(
            _ref_cfg(arch), REF_SHAPES[name]), name


# --------------------------------------------------------------------------
# the collective counter's wire factors
# --------------------------------------------------------------------------

def _drive(kind):
    """(wire bytes, count) the counter records for one collective of
    ``kind`` on a 4-rank fake group, through ``torch.distributed`` and
    (where it has one) the functional op DTensor calls."""
    import torch.distributed._functional_collectives as fc
    x = torch.ones(64, 8)                       # 2 KiB
    with CollectiveMode() as cm:
        if kind == "all-gather":
            dist.all_gather_into_tensor(torch.empty(256, 8), x)
            fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD))
        elif kind == "reduce-scatter":
            dist.reduce_scatter_tensor(torch.empty(16, 8), x)
            fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0,
                                                    dist.group.WORLD))
        elif kind == "all-reduce":
            dist.all_reduce(x)
            fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))
        elif kind == "all-to-all":
            dist.all_to_all_single(torch.empty(64, 8), x)
            fc.wait_tensor(fc.all_to_all_single(x, None, None,
                                                dist.group.WORLD))
        else:
            dist.send(x, 1)
    return collective_bytes(cm), collective_counts(cm)


@pytest.mark.parametrize("kind,factor", [
    ("all-gather", 4 * 3 / 4),             # out (4 x 2 KiB) * (P-1)/P
    ("reduce-scatter", 3 / 4),             # in * (P-1)/P
    ("all-reduce", 2 * 3 / 4),             # 2 * size * (P-1)/P
    ("all-to-all", 3 / 4),                 # size * (P-1)/P
    ("collective-permute", 1.0),           # size: one hop
])
def test_collective_wire_factors(kind, factor, fake_group):
    fake_group(4)
    wire, counts = _drive(kind)
    calls = 1 if kind == "collective-permute" else 2
    assert counts == {kind: calls}
    assert wire[kind] == pytest.approx(calls * factor * 64 * 8 * 4)
    assert wire["total"] == wire[kind]
    size = 4 * 2048 if kind == "all-gather" else 2048      # out / in / size
    assert wire_bytes(kind, size, 4) == pytest.approx(factor * 2048)


# --------------------------------------------------------------------------
# processes: the reference in 4 host devices, gloo ranks
# --------------------------------------------------------------------------

SMALL_SHAPES = {"train_4k": ("train", 64, 8), "prefill_32k": ("prefill", 64, 4),
                "decode_32k": ("decode", 64, 4)}
DRY_ARCHS = ["internlm2_1_8b", "qwen3_moe_30b_a3b", "hymba_1_5b"]

REFERENCE_BODY = """
import json, os, sys, dataclasses
sys.path.insert(0, "src")
import repro.launch.dryrun as D          # sets XLA_FLAGS to 512 devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.core.distributed import _shard_map
from repro.optim.compression import compressed_psum
out = {{}}
mesh = jax.make_mesh((4,), ("pod",))
x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
out["psum"] = np.asarray(_shard_map(lambda v: compressed_psum(v, "pod"), mesh,
                                    (P("pod"),), P())(x)).tolist()
for name, (kind, s, b) in {shapes!r}.items():
    D.SHAPES[name] = ShapeConfig(name, s, b, kind)
# Auto axes: jax 0.9's default Explicit axes turn the models'
# with_sharding_constraint into an assert
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
for arch in {archs!r}:
    ov = lambda c, a=arch: dataclasses.replace(get_smoke_config(a),
                                               dispatch_groups=c.dispatch_groups)
    for name in {shapes!r}:
        art = D.lower_cell(arch, name, mesh, "fake22", cfg_override=ov,
                           fit_layers=False)
        out[arch + "/" + name] = art["memory_analysis"]["argument_bytes"]
with open({path!r}, "w") as f:
    json.dump(out, f)
"""


PORT_DRYRUN_BODY = """
import dataclasses, json, logging, sys
sys.path.insert(0, "src")
logging.disable(logging.WARNING)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D, mesh as M
for name, (kind, s, b) in {shapes!r}.items():
    D.SHAPES[name] = ShapeConfig(name, s, b, kind)
M.open_fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {{}}
for arch in {archs!r}:
    ov = lambda c, a=arch: dataclasses.replace(get_smoke_config(a),
                                               dispatch_groups=c.dispatch_groups)
    for name in {shapes!r}:
        out[arch + "/" + name] = D.lower_cell(arch, name, mesh, "fake22",
                                              cfg_override=ov)
M.close_group()
with open({path!r}, "w") as f:
    json.dump(out, f, default=str)
"""


def _python(body, tmp, name, **env):
    """Run ``body`` (formatted with the small shapes, the dry-run archs and
    its output path) in a fresh interpreter; return its JSON output."""
    path = os.path.join(tmp, name + ".json")
    script = body.format(shapes=SMALL_SHAPES, archs=DRY_ARCHS, path=path)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, **env), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _smoke(arch="qwen3_moe_30b_a3b", groups=1):
    return dataclasses.replace(get_smoke_config(arch), dispatch_groups=groups)


def _smoke_state(cfg, seed=3):
    from repro_torch.models import init_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    return TrainState(params, get_optimizer(cfg.optimizer).init(params),
                      torch.zeros((), dtype=torch.int32))


def _smoke_batch(cfg, b=4, s=16):
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (b, s))
    return {"tokens": torch.from_numpy(tok.astype(np.int32))}


def _train_step(cfg, state, batch, mesh=None):
    """One ``make_train_step`` step (warm-up skipped: lr > 0) on the plain
    tensors, or on DTensors placed by the rules on ``mesh``; returns
    (loss, grad norm, params, grads) as plain tensors."""
    from repro_torch.core.interop import tree_flatten
    from repro_torch.train import TrainState, make_train_step
    _, step = make_train_step(cfg, warmup=0)
    state = TrainState(*state[:2], torch.ones((), dtype=torch.int32))
    grads = []

    def keep(p):
        grads.append(p)
    if mesh is not None:
        state = TrainState(
            shd.distribute(state.params, shd.param_shardings(
                state.params, cfg, mesh), mesh),
            shd.distribute(state.opt_state, shd.param_shardings(
                state.opt_state, cfg, mesh), mesh), state.step)
        batch = shd.distribute(batch, shd.to_shardings(shd.batch_specs(
            cfg, mesh, SHAPES["train_4k"]), mesh), mesh)
        with M.use_mesh(mesh):
            new, m = step(state, batch)
    else:
        new, m = step(state, batch)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    leaves = [full(p) for p in tree_flatten(new.params)[0]]
    return full(m["loss"]), full(m["grad_norm"]), leaves


def _psum_rank(rank, store, tmp):
    from repro_torch.optim import compressed_psum
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=4)
    try:
        x = np.random.default_rng(0).standard_normal((4, 256)).astype(
            np.float32)
        out = compressed_psum(torch.from_numpy(x[rank:rank + 1]))
        np.save(os.path.join(tmp, f"psum{rank}.npy"), out.numpy())
    finally:
        dist.destroy_process_group()


def _mesh_rank(rank, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        out = {}
        cfg = _smoke(groups=2)
        for shape in ((2, 1), (1, 2)):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            loss, gn, leaves = _train_step(cfg, _smoke_state(cfg),
                                           _smoke_batch(cfg), mesh)
            tag = f"{shape[0]}x{shape[1]}"
            out[tag + "/loss"] = loss.numpy()
            out[tag + "/gnorm"] = gn.numpy()
            for i, t in enumerate(leaves):
                out[f"{tag}/{i}"] = t.numpy()
        np.savez(os.path.join(tmp, f"mesh{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(fn, n, tmp, tag):
    import torch.multiprocessing as mp
    os.makedirs(os.path.join(tmp, tag), exist_ok=True)
    mp.spawn(fn, args=(os.path.join(tmp, tag, "store"), tmp), nprocs=n,
             join=True)


class _Started:
    """Background jobs of the module: ``get(name)`` waits for one."""

    def __init__(self, tmp, futures):
        self.tmp, self._futures = tmp, futures

    def get(self, name):
        return self._futures[name].result()


@pytest.fixture(scope="module", autouse=True)
def processes(tmp_path_factory):
    """Started with the module, so they run while its other tests do: the
    reference in 4 host devices (``compressed_psum`` under ``shard_map``,
    ``lower_cell``'s argument bytes), the port's dry run of the smoke
    cells, the 4 gloo ranks of ``compressed_psum`` and the 2 gloo mesh
    ranks."""
    tmp = str(tmp_path_factory.mktemp("launch"))
    pool = ThreadPoolExecutor(4)
    jobs = _Started(tmp, {
        "reference": pool.submit(_python, REFERENCE_BODY, tmp, "reference",
                                 JAX_PLATFORMS="cpu"),
        "dryrun": pool.submit(_python, PORT_DRYRUN_BODY, tmp, "dryrun"),
        "psum": pool.submit(_spawn, _psum_rank, 4, tmp, "psum"),
        "mesh": pool.submit(_spawn, _mesh_rank, 2, tmp, "mesh")})
    yield jobs
    pool.shutdown(wait=True)


def test_compressed_psum_matches_reference(processes):
    """4 gloo ranks, one row each: every rank's sum equals the reference's
    under ``shard_map`` to 1e-6 relative, and the exact sum to 0.05."""
    x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
    want = np.asarray(processes.get("reference")["psum"], np.float32)
    processes.get("psum")
    exact = x.sum(0, keepdims=True)
    for r in range(4):
        got = np.load(os.path.join(processes.tmp, f"psum{r}.npy"))
        assert got.shape == (1, 256) and got.dtype == np.float32
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
        assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 0.05


def test_compressed_psum_one_rank_is_a_round_trip(tmp_path):
    """On one rank the sum is the int8 round trip, bit for bit, also for a
    ``(DeviceMesh, dim name)`` group."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim import (compressed_psum, int8_compress,
                                   int8_decompress)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (3, 700)).astype(np.float32))
        want = int8_decompress(*int8_compress(x), x.shape)
        assert torch.equal(compressed_psum(x), want)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        assert torch.equal(compressed_psum(x, (mesh, "data")), want)
        with CollectiveMode() as cm:
            compressed_psum(x)
        assert collective_counts(cm) == {"all-gather": 2}
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_step_is_bit_equal(tmp_path):
    """The smoke Qwen3 train step on a (1, 1) gloo mesh with DTensor
    parameters: loss, gradient norm and every updated parameter bit for bit
    the plain step's; the off-mesh hooks are no-ops."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import layers
    cfg = _smoke()
    want = _train_step(cfg, _smoke_state(cfg), _smoke_batch(cfg))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        got = _train_step(cfg, _smoke_state(cfg), _smoke_batch(cfg), mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    x = torch.ones(2, 3)
    assert layers.constrain(x, shd.P("data", None)) is x
    assert layers.dp_axes() == () and M.bound_mesh() is None


def test_two_rank_meshes_match_plain(processes):
    """Two gloo ranks at (2, 1) and (1, 2): loss and gradient norm within
    2e-5 relative of the plain step (float32 partial sums taken across
    ranks in another order), the updated parameters within 3e-6 (1 % of
    the step's lr: Adam's g / (|g| + eps) turns a last-bit difference of a
    gradient near eps into a visible one)."""
    cfg = _smoke(groups=2)
    loss, gn, leaves = _train_step(cfg, _smoke_state(cfg), _smoke_batch(cfg))
    processes.get("mesh")
    for r in range(2):
        got = dict(np.load(os.path.join(processes.tmp, f"mesh{r}.npz")))
        for tag in ("2x1", "1x2"):
            np.testing.assert_allclose(got[tag + "/loss"], loss.numpy(),
                                       rtol=2e-5, atol=0)
            np.testing.assert_allclose(got[tag + "/gnorm"], gn.numpy(),
                                       rtol=2e-5, atol=0)
            for i, t in enumerate(leaves):
                np.testing.assert_allclose(got[f"{tag}/{i}"], t.numpy(),
                                           rtol=0, atol=3e-6)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------

#: the port's decode cache holds ``length`` as a Python int; the
#: reference's is a 4-byte int32 argument
DECODE_LENGTH_BYTES = 4


def test_dry_run_smoke_cells(processes):
    """The port's dry run of a dense, an MoE and a hybrid smoke config on a
    fake (2, 2) mesh: every cell ``ok`` with positive terms, and its
    argument bytes per chip the reference ``lower_cell``'s (the
    optimizer states have the same layout: AdamW)."""
    ref, port = processes.get("reference"), processes.get("dryrun")
    for arch in DRY_ARCHS:
        for name in SMALL_SHAPES:
            art = port[arch + "/" + name]
            assert art["ok"] and art["chips"] == 4 and art["layer_fit"] == {}
            for k in ("counted_flops_per_chip", "t_memory_s",
                      "mem_per_chip_gib"):
                assert art[k] > 0, (arch, name, k)
            assert art["collective_bytes"]["total"] > 0
            want = ref[arch + "/" + name]
            if name == "decode_32k":
                want -= DECODE_LENGTH_BYTES
            assert art["memory"]["argument_bytes"] == want, (arch, name)


def test_dry_run_cli_records_skips_and_failures(fake_group, tmp_path,
                                                monkeypatch):
    """``run_cells`` writes one file per cell and ``summary.json``; the
    long-context shape is skipped for full-attention archs, as the
    reference skips it, and a failing cell is recorded, not raised."""
    from repro_torch.launch import dryrun

    def boom(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    monkeypatch.setitem(dryrun.MESH_RANKS, "pod", 256)
    res = dryrun.main(["--arch", "internlm2_1_8b", "--mesh", "pod",
                       "--out", str(tmp_path)])
    assert [r["shape"] for r in res] == list(SHAPES)
    assert "skipped" in res[-1] and not res[-1]["ok"]
    assert all(r["error"] == "RuntimeError: no" for r in res[:-1])
    with open(tmp_path / "summary.json") as f:
        assert len(json.load(f)) == len(SHAPES)
    assert (tmp_path / "pod_internlm2_1_8b_train_4k.json").exists()
    assert not dist.is_initialized()


def test_importing_launch_modules_opens_no_group():
    code = textwrap.dedent("""
        import torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.launch.sharding
        import repro_torch.utils, repro_torch.optim
        assert not dist.is_initialized()
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_a_real_group_is_nccl_on_the_gpu_or_raises():
    """``open_group()`` is NCCL on the card; without one it raises instead
    of opening a CPU group (gloo only when asked for)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the NCCL group would open")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.open_group()
    assert not dist.is_initialized()
