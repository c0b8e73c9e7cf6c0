"""Probe: can this host lay the 512-rank (2, 16, 16) ("pod", "data",
"model") production mesh over a fake process group, run a sharded step on
it, and launch the collectives the models use?  Prints ``PROBE OK``.

The port of ``scripts/probe_multipod.py``, built from the dry run's parts
(``repro_torch.launch.mesh`` and ``launch/dryrun.py``):

  * ``mesh.open_fake_group(512)`` (this process is rank 0; collectives
    return at once and move nothing) and ``make_production_mesh(
    multi_pod=True, device_type="cpu")``;
  * the step ``mean(tanh(x @ w)**2)`` on meta DTensors: ``x`` (256, 1024)
    bf16 with its rows over the data axes, ``w`` (1024, 4096) bf16 with
    its columns over ``model``.  It runs on the dry run's merged
    (pod·data, model) = (32, 16) mesh (``dryrun.merged_data_mesh``):
    DTensor refused a tensor dim sharded over two mesh dims, and its
    planner took minutes on the 3-D mesh.  Memory is reckoned as the dry
    run reckons it (this rank's argument shards plus the step's peak of
    live bytes, ``dryrun.StepCounter``), FLOPs by ``FlopCounterMode``;
  * the five explicit collectives on the 3-D mesh's sub-groups, on this
    rank's (16, 64) float32 block of a (512, 1024) array: all-reduce over
    ``data``, all-gather, reduce-scatter and all-to-all over ``model``,
    and a one-hop permute (a send and a receive) over ``pod``; each
    counted by ``utils.collectives`` and sized by its wire factors.

The counts are the port's own: XLA's counts (``all-to-all 18``) come from
its lowering.  All of it is host work on meta tensors and a fake group;
like the port's other entry points the probe still stops without a card
unless it is given ``--device cpu``.

    python scripts/torch_probe_multipod.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.core.interop import resolve_device  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.dryrun import (StepCounter, local_bytes,  # noqa: E402
                                       merged_data_mesh)
from repro_torch.utils.collectives import (CollectiveMode,  # noqa: E402
                                           collective_bytes,
                                           collective_counts)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def step(x, w):
    # data-parallel batch, model-parallel feature; exercise the standard
    # collectives
    y = x @ w
    y = torch.tanh(y)
    return torch.mean(y ** 2)


def explicit_collectives(mesh):
    """The reference's shard_map chain on this rank's block of a
    (512, 1024) float32 array laid out (("pod", "data"), "model")."""
    sizes = M.axis_sizes(mesh)
    x = torch.zeros(512 // (sizes["pod"] * sizes["data"]),
                    1024 // sizes["model"])
    dist.all_reduce(x, group=mesh.get_group("data"))
    model = mesh.get_group("model")
    p = sizes["model"]
    gathered = torch.empty((p * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(gathered, x, group=model)
    flat = gathered.reshape(-1)
    scattered = torch.empty(flat.numel() // p)
    dist.reduce_scatter_tensor(scattered, flat, group=model)
    exchanged = torch.empty_like(scattered)
    dist.all_to_all_single(exchanged, scattered, group=model)
    pod = mesh.get_group("pod")
    peer = dist.get_global_rank(pod, 1 - dist.get_group_rank(
        pod, dist.get_rank()))
    received = torch.empty_like(exchanged)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, exchanged, peer, pod),
            dist.P2POp(dist.irecv, received, peer, pod)]):
        req.wait()
    return {"block": list(x.shape), "gathered": list(gathered.shape),
            "scattered": scattered.numel()}


def run(device=None) -> dict:
    """The probe; returns the step's reckoning and the collectives'
    counts and per-rank wire bytes."""
    resolve_device(device)
    M.close_group()
    M.open_fake_group(512)
    try:
        print("devices:", dist.get_world_size())
        mesh3 = M.make_production_mesh(multi_pod=True, device_type="cpu")
        print("mesh ok:", M.axis_sizes(mesh3))
        mesh = merged_data_mesh(mesh3)
        print("step mesh:", M.axis_sizes(mesh), "(pod·data merged, as the "
              "dry run lowers multipod cells)")

        t0 = time.time()
        x = shd.distribute(torch.empty((256, 1024), dtype=torch.bfloat16,
                                       device="meta"),
                           shd.to_placements(shd.P("data", None), mesh), mesh)
        w = shd.distribute(torch.empty((1024, 4096), dtype=torch.bfloat16,
                                       device="meta"),
                           shd.to_placements(shd.P(None, "model"), mesh),
                           mesh)
        print("placed in %.1fs" % (time.time() - t0))
        t0 = time.time()
        counter = StepCounter()
        with counter:
            loss = step(x, w).full_tensor()
        print("ran in %.1fs" % (time.time() - t0))
        flops = FlopCounterMode(display=False)
        with flops:
            step(x, w).full_tensor()
        mem = {"argument_bytes": local_bytes((x, w)),
               "peak_step_bytes": counter.peak_bytes}
        print("mem:", mem)
        print("cost:", {"flops": flops.get_total_flops(),
                        "local_flops": counter.flops,
                        "hbm_bytes": counter.hbm_bytes,
                        "loss": tuple(loss.shape)})
        print("step collectives:", collective_counts(counter))

        # the explicit collectives on the 3-D mesh's sub-groups
        t0 = time.time()
        mode = CollectiveMode()
        with mode:
            shapes = explicit_collectives(mesh3)
        print("explicit collectives ran in %.1fs" % (time.time() - t0),
              shapes)
        counts, wire = collective_counts(mode), collective_bytes(mode)
        for kind in KINDS:
            print(f"{kind} {counts.get(kind, 0)} "
                  f"wire_bytes={wire.get(kind, 0.0):.0f}")
        missing = [k for k in KINDS if not counts.get(k)]
        assert not missing, f"collectives not seen: {missing}"
        print("PROBE OK")
        return {"mem": mem, "flops": flops.get_total_flops(),
                "step_collectives": collective_counts(counter),
                "counts": counts, "wire_bytes": wire, "shapes": shapes}
    finally:
        M.close_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="as the port's other entry points take it; the "
                         "probe itself runs on the host")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
