"""Generate the dry-run and roofline markdown tables from the port's
dry-run artifacts.

The port of ``scripts/make_experiments_tables.py``.  It reads what
``python -m repro_torch.launch.dryrun`` writes (one JSON file per cell and
``summary.json``), whose keys are the port's: ``fits_80gb``, ``build_s``
/ ``run_s``, ``memory.{argument_bytes, peak_step_bytes}`` and the
roofline terms reckoned with the H100's constants (``utils/roofline.py``).
The reference's script stops at the first of them (``KeyError:
'fits_16gib'``).  Its output is ``artifacts/tables_torch.md``, so the
reference's ``artifacts/tables.md`` is never overwritten.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh both --optimized --out artifacts/dryrun_torch_opt
  python scripts/torch_make_experiments_tables.py [baseline_dir] [opt_dir]

Both directories may hold the cells of both meshes.  Without a card and
without ``--device cpu`` it stops with the port's "no CUDA device" error,
as every entry point of the port does; the tables themselves are host
work.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.interop import resolve_device  # noqa: E402

MESH_TITLE = {"pod": "16x16 = 256 GPUs", "multipod": "2x16x16 = 512 GPUs"}
OUT = os.path.join("artifacts", "tables_torch.md")


def load(out_dir):
    arts = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if path.endswith("summary.json"):
            continue
        with open(path) as f:
            a = json.load(f)
        arts[(a["mesh"], a["arch"], a["shape"])] = a
    return arts


def fmt_ms(s):
    return f"{s*1e3:,.0f}"


def roofline_table(arts, mesh):
    rows = ["| arch | shape | step | t_comp ms | t_mem ms | t_coll ms | bound | "
            "useful/counted | MFU-bound | GiB/GPU | fits 80 GB |",
            "|---|---|---|---:|---:|---:|---|---:|---:|---:|---|"]
    for (m, arch, shape), a in sorted(arts.items()):
        if m != mesh or not a.get("ok"):
            continue
        rows.append(
            f"| {arch} | {shape} | {a['step']} | {fmt_ms(a['t_compute_s'])} "
            f"| {fmt_ms(a['t_memory_s'])} | {fmt_ms(a['t_collective_s'])} "
            f"| {a['bottleneck'][:4]} | {a['useful_flops_frac']:.2f} "
            f"| {a['mfu_bound']*100:.1f}% | {a['mem_per_chip_gib']:.1f} "
            f"| {'Y' if a['fits_80gb'] else 'n'} |")
    return "\n".join(rows)


def compare_table(base, opt, mesh="pod"):
    rows = ["| arch | shape | t_mem ms (base -> opt) | t_coll ms (base -> opt) | "
            "GiB/GPU (base -> opt) | bound (opt) |",
            "|---|---|---|---|---|---|"]
    for key in sorted(base):
        m, arch, shape = key
        if m != mesh or key not in opt:
            continue
        b, o = base[key], opt[key]
        if not (b.get("ok") and o.get("ok")):
            continue
        rows.append(
            f"| {arch} | {shape} "
            f"| {fmt_ms(b['t_memory_s'])} -> {fmt_ms(o['t_memory_s'])} "
            f"| {fmt_ms(b['t_collective_s'])} -> {fmt_ms(o['t_collective_s'])} "
            f"| {b['mem_per_chip_gib']:.1f} -> {o['mem_per_chip_gib']:.1f} "
            f"| {o['bottleneck'][:4]} |")
    return "\n".join(rows)


def dryrun_table(arts, skips, mesh):
    rows = ["| arch | shape | step | build s | run s | args GiB/GPU | "
            "peak step GiB/GPU | collectives (AR/AG/RS/A2A/CP) |",
            "|---|---|---|---:|---:|---:|---:|---|"]
    for (m, arch, shape), a in sorted(arts.items()):
        if m != mesh:
            continue
        if not a.get("ok"):
            continue
        cc = a.get("collective_counts", {})
        counts = "/".join(str(cc.get(k, 0)) for k in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        mem = a.get("memory", {})
        rows.append(
            f"| {arch} | {shape} | {a['step']} | {a.get('build_s', 0):.1f} "
            f"| {a.get('run_s', 0):.1f} "
            f"| {mem.get('argument_bytes', 0)/2**30:.2f} "
            f"| {mem.get('peak_step_bytes', 0)/2**30:.2f} | {counts} |")
    for s in skips:
        if s["mesh"] == mesh:
            rows.append(f"| {s['arch']} | {s['shape']} | SKIP | - | - | - "
                        f"| - | {s['skipped'][:60]} |")
    return "\n".join(rows)


def run(base_dir="artifacts/dryrun_torch", opt_dir="artifacts/dryrun_torch_opt",
        out_path=OUT, device=None) -> str:
    """Write the tables to ``out_path``; returns their markdown."""
    resolve_device(device)
    base = load(base_dir)
    opt = load(opt_dir) if os.path.isdir(opt_dir) else {}
    skips = []
    sumpath = os.path.join(opt_dir if opt else base_dir, "summary.json")
    if os.path.exists(sumpath):
        with open(sumpath) as f:
            skips = [r for r in json.load(f) if "skipped" in r]

    out = []
    for mesh in ("pod", "multipod"):
        out.append(f"\n### Dry-run — {mesh} mesh ({MESH_TITLE[mesh]})\n")
        out.append(dryrun_table(opt or base, skips, mesh))
    out.append("\n### Roofline — baseline (paper-faithful substrate, naive "
               "attention), single pod, H100 constants\n")
    out.append(roofline_table(base, "pod"))
    if opt:
        out.append("\n### Roofline — optimized (flash attention), single "
                   "pod, H100 constants\n")
        out.append(roofline_table(opt, "pod"))
        out.append("\n### Baseline -> optimized per-cell deltas (single pod)\n")
        out.append(compare_table(base, opt))
        out.append("\n### Roofline — optimized, multi-pod (512 GPUs)\n")
        out.append(roofline_table(opt, "multipod"))
    text = "\n".join(out)
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(text)
    print("wrote", out_path, len(base), "baseline cells,",
          len(opt), "optimized cells")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base_dir", nargs="?", default="artifacts/dryrun_torch")
    ap.add_argument("opt_dir", nargs="?", default="artifacts/dryrun_torch_opt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="as the port's other entry points take it; the "
                         "tables are host work")
    args = ap.parse_args(argv)
    run(args.base_dir, args.opt_dir, device=args.device)


if __name__ == "__main__":
    main()
