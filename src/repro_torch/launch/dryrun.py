"""Multi-pod dry run: run every (architecture x shape x mesh) cell's real
step on shapes alone, against the production mesh (port of
``repro.launch.dryrun``).

For each cell the dry run:
  1. opens a fake process group of 256 (``pod``, 16x16) or 512
     (``multipod``, 2x16x16) ranks, this process rank 0, and builds the
     ``DeviceMesh`` of ``launch/mesh.py`` on it;
  2. builds the parameters, optimizer state, batch and decode cache as meta
     tensors (shapes and dtypes only: nothing is drawn or allocated) and
     places them as DTensors by the name-based rules of
     ``launch/sharding.py``;
  3. runs the real step under the mesh (``launch.mesh.use_mesh``, which
     binds the models' ``constrain`` hooks): train is ``loss_fn`` +
     backward + ``clip_by_global_norm`` + the optimizer's update
     (``train.make_train_step``); prefill and decode are
     ``models.prefill`` / ``models.decode_step``;
  4. counts, while it runs, over the local ops each rank runs: FLOPs (by
     ``torch.utils.flop_counter``'s formulas), the collectives' wire bytes
     and sites (``utils.collectives``), HBM bytes, and the live bytes of
     what the step allocates;
  5. writes the roofline row (``utils.roofline``, H100 constants) to one
     JSON file per cell and ``summary.json``.

What the numbers are:
  * ``flops_per_chip`` sums ``flop_counter``'s formula of every local op
    rank 0 runs, at its local shapes: the chip's own FLOPs, work that is
    replicated over a mesh axis counted on each chip.  (A
    ``FlopCounterMode`` over the DTensor ops would count the global
    product, but the attention cores and the dispatch tables run under
    ``local_map`` on local tensors, which it would count locally: the two
    cannot be added.)
  * ``hbm_bytes_per_chip`` sums, over every local op a rank runs (views
    and allocations excepted), its input and output bytes at the local
    (per-rank) shapes.  Torch has no compiler's ``bytes accessed``: this is
    an UNFUSED upper bound (every intermediate written and read back).
  * memory per chip has two parts: the argument bytes (each rank's shards
    of the parameters, optimizer state, batch and cache; exact) and the
    peak of the live bytes the step allocates on top of them (a storage
    tracker on the local ops).  ``mem_per_chip`` is their sum.
  * There is no two-point layer fit (``layer_fit`` is ``{}``).  The
    reference fits cost(L) = a + b*L because XLA's cost model counts a
    ``scan`` body once; the port's transformer is a Python loop over its
    layers, so a full-depth run counts every layer.
  * On meta tensors the MoE dispatch's partition engine resolves to
    ``argsort`` (the kernels need data); its counts are that engine's.

A failing cell is recorded with its error, as the reference records it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_moe_30b_a3b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._guards import active_fake_mode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.layers import constrain
from repro_torch.optim import get_optimizer
from repro_torch.train import TrainState, make_train_step
from repro_torch.utils.collectives import (CollectiveMode, collective_bytes,
                                           collective_counts)
from repro_torch.utils.roofline import Roofline, model_flops

MESH_RANKS = {"pod": 256, "multipod": 512}


def input_specs(cfg, shape_cfg):
    """Meta stand-ins for every model input of this cell (global shapes)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind in ("train", "prefill"):
        text = s - (cfg.num_patches if cfg.frontend == "vision_patches" else 0)
        batch = {"tokens": torch.empty((b, text), dtype=torch.int32,
                                       device="meta")}
        if cfg.frontend == "vision_patches":
            batch["patches"] = torch.empty((b, cfg.num_patches, cfg.d_model),
                                           dtype=torch.float32, device="meta")
        return batch
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return {"token": token, "cache": init_cache(cfg, b, s, device="meta")}


def _prepare(arch: str, shape_name: str, mesh):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dispatch_groups=M.data_shards(mesh))
    return cfg, SHAPES[shape_name]


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for _, t in shd.leaves_with_paths(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


class StepCounter(CollectiveMode):
    """The collective counter plus, for every other local op, its FLOPs
    (``flops``), its input and output bytes (``hbm_bytes``) and the live
    bytes of the storages it allocates (``peak_bytes``: the most alive at
    once)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def __enter__(self):
        # everything alive before the step (its arguments) is not the
        # step's: only storages made while the mode is on are tracked
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def on_op(self, func, args, kwargs, out) -> None:
        if active_fake_mode() is not self._fake_on_entry:
            return                  # DTensor's own shape propagation
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return
        self.ops += 1
        self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.hbm_bytes += sum(_nbytes(t) for t in outs)


#: ops that move no bytes: allocations and metadata
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided, torch.ops.aten.detach,
               torch.ops.aten.lift_fresh, torch.ops.aten._local_scalar_dense}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _place(tree, specs, mesh):
    return shd.distribute(tree, shd.to_shardings(specs, mesh), mesh)


def _step(cfg, shape_cfg, mesh, step_kind):
    """(step function of no arguments, argument bytes per chip)."""
    params = init_params(cfg, device="meta")
    dparams = shd.distribute(params, shd.param_shardings(params, cfg, mesh),
                             mesh)
    b = shape_cfg.global_batch
    dp = shd._norm_axis(M.data_axes(mesh))
    b_ok = b % M.data_shards(mesh) == 0
    if step_kind == "train":
        opt, step_fn = make_train_step(cfg, optimizer_name=cfg.optimizer)
        opt_state = get_optimizer(cfg.optimizer).init(params)
        dopt = shd.distribute(opt_state, shd.param_shardings(
            opt_state, cfg, mesh), mesh)
        batch = _place(input_specs(cfg, shape_cfg),
                       shd.batch_specs(cfg, mesh, shape_cfg), mesh)
        state = TrainState(dparams, dopt, torch.zeros((), dtype=torch.int32,
                                                      device="meta"))
        return lambda: step_fn(state, batch), local_bytes((state, batch))
    cspecs = shd.cache_specs(cfg, mesh, b, shape_cfg.seq_len)
    if step_kind == "prefill":
        batch = _place(input_specs(cfg, shape_cfg),
                       shd.batch_specs(cfg, mesh, shape_cfg), mesh)
        v_ok = cfg.padded_vocab % M.model_shards(mesh) == 0
        lspec = shd.P(dp if b_ok else None, None, "model" if v_ok else None)

        def run():
            with torch.no_grad():
                logits, cache = prefill(dparams, cfg, batch)
            # the reference's out_shardings
            cache = cache._replace(**{
                f: tuple(constrain(t, getattr(cspecs, f)) for t in ts)
                for f, ts in cache._asdict().items()
                if ts is not None and f != "length"})
            return constrain(logits, lspec), cache
        return run, local_bytes((dparams, batch))
    spec = input_specs(cfg, shape_cfg)
    token = _place(spec["token"], shd.P(dp, None) if b_ok else shd.P(), mesh)
    cache = shd.distribute(spec["cache"], shd.to_shardings(cspecs, mesh), mesh)

    def run():
        with torch.no_grad():
            return decode_step(dparams, cfg, token, cache)
    return run, local_bytes((dparams, token, cache))


def merged_data_mesh(mesh):
    """The mesh the model runs on: a production mesh with a ``pod`` axis as
    the same ranks in (pod x data, model), the pod-major merge of pod and
    data named ``data`` (rank pod·256 + data·16 + model in both; a
    collective over both axes has the same 32-rank group).  DTensor's
    redistribution planner searches every shard order when one tensor dim
    is sharded over two mesh dims, and a multipod cell on the 3-D mesh
    took more than 15 minutes; on the merged mesh the sharding rules make
    the same choices (``_div`` reads the product of the data axes)."""
    if "pod" not in M.axis_names(mesh):
        return mesh
    return init_device_mesh(mesh.device_type,
                            (M.data_shards(mesh), M.model_shards(mesh)),
                            mesh_dim_names=("data", "model"))


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               step_override: str = None, cfg_override=None):
    """Run one cell's step on meta DTensors; returns the artifact dict."""
    cfg, shape_cfg = _prepare(arch, shape_name, mesh)
    if cfg_override:
        cfg = cfg_override(cfg)
    step_kind = step_override or ("train" if shape_cfg.kind == "train" else
                                  "prefill" if shape_cfg.kind == "prefill"
                                  else "decode")
    chips = mesh.size()
    t0 = time.time()
    run, arg_bytes = _step(cfg, shape_cfg, mesh, step_kind)
    t_build = time.time() - t0
    t0 = time.time()
    counter = StepCounter()
    with M.use_mesh(mesh), counter:
        run()
    t_run = time.time() - t0
    coll = collective_bytes(counter)
    mem = arg_bytes + counter.peak_bytes
    rl = Roofline(
        arch=arch, shape=shape_name, step=step_kind, mesh=mesh_name,
        chips=chips,
        flops_per_chip=float(counter.flops),
        hbm_bytes_per_chip=counter.hbm_bytes,
        coll_bytes_per_chip=coll["total"],
        model_flops_global=model_flops(cfg, shape_cfg),
        mem_per_chip=float(mem),
    )
    art = {
        **rl.row(),
        "build_s": t_build, "run_s": t_run, "layer_fit": {},
        "collective_bytes": coll, "collective_counts":
            collective_counts(counter),
        "memory": {"argument_bytes": arg_bytes,
                   "peak_step_bytes": counter.peak_bytes},
        "local_ops": counter.ops,
        "ok": True,
    }
    print(f"[dryrun] {mesh_name}/{arch}/{shape_name}/{step_kind}: "
          f"mem={art['mem_per_chip_gib']:.2f} GiB/chip "
          f"t_comp={rl.t_compute*1e3:.2f}ms t_mem={rl.t_memory*1e3:.2f}ms "
          f"t_coll={rl.t_collective*1e3:.2f}ms -> {rl.bottleneck} "
          f"(run {t_run:.1f}s)", flush=True)
    return art


def run_cells(archs, shapes, meshes, out_dir, cfg_override=None):
    """Every cell of ``archs`` x ``shapes`` (None: all four) x ``meshes``,
    each mesh on its own fake process group (opened here, closed after)."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for mesh_name in meshes:
        M.close_group()
        M.open_fake_group(MESH_RANKS[mesh_name])
        try:
            mesh = merged_data_mesh(M.make_production_mesh(
                multi_pod=(mesh_name == "multipod"), device_type="cpu"))
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes or list(SHAPES):
                    if (shape_name == "long_500k"
                            and not cfg.supports_long_context):
                        results.append({
                            "arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "ok": False,
                            "skipped": "full-attention arch: 524k dense KV "
                                       "decode is the quadratic regime this "
                                       "shape excludes"})
                        continue
                    tag = f"{mesh_name}_{arch}_{shape_name}"
                    try:
                        art = lower_cell(arch, shape_name, mesh, mesh_name,
                                         cfg_override=cfg_override)
                    except Exception as e:  # a failure here is a bug: record it
                        traceback.print_exc()
                        art = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "ok": False,
                               "error": f"{type(e).__name__}: {e}"}
                    results.append(art)
                    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                        json.dump(art, f, indent=2, default=str)
        finally:
            M.close_group()
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    bad = [r for r in results if not r.get("ok") and "skipped" not in r]
    print(f"[dryrun] {len(results)} cells, {len(bad)} failures", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper config: flash attention everywhere")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = None if (args.all or not args.shape) else [args.shape]
    override = None
    if args.optimized:
        override = lambda c: dataclasses.replace(c, attention_impl="flash")  # noqa: E731
    return run_cells(archs, shapes, meshes, args.out, cfg_override=override)


if __name__ == "__main__":
    main()
