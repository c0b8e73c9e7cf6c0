"""The contract registry: every public entry point, verified on a recorded run.

Each engine module keeps a pure-data ``ANALYSIS_CONTRACT`` declaration
(census formulas, sort-free flag, in-place counts, transfer formulas) next
to the code it constrains — the reference's declarations, key for key,
with ``entry`` naming the port's function.  This module binds those
declarations to *run recipes*: a representative input per entry point at
the reference's shapes, random from a seed (all-zero keys would elide
every pass), run once under the launch recorder (``trace``) and the sort
counter, on the card or — when the caller asks — on the CPU through the
kernels' plain versions.

A :class:`Contract` is (name, decl, make, shards) where ``make(device) ->
(run, params)``: ``run()`` makes the call, ``params(result)`` builds the
formula environment (passes, classes, n_pad, ...) from the exported
``*_params`` helpers — equal to the reference's — with the run's own
executed passes and attempts put in.  ``shards`` repeats the per-shard
census for a ``LocalMesh`` that holds that many shards in one process.

``run_all(device)`` is the whole sweep (plus the descriptor-table checks of
:func:`table_checks`); ``python -m repro_torch.analysis`` drives it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis import census as _census
from repro_torch.analysis import donation as _donation
from repro_torch.analysis import expr, refhazard
from repro_torch.analysis import transfer as _transfer
from repro_torch.analysis.trace import REPLAYED, recording
from repro_torch.core import interop, model, plan
from repro_torch.core import distributed as core_distributed
from repro_torch.core import hybrid as core_hybrid
from repro_torch.core import lsd as core_lsd
from repro_torch.core import outofcore as core_outofcore
from repro_torch.core.hybrid import hybrid_sort, local_sort_classes
from repro_torch.core.lsd import lsd_sort
from repro_torch.core.segmented import capacity_dispatch, counting_partition
from repro_torch.data import pipeline as data_pipeline
from repro_torch.kernels import fused
from repro_torch.kernels import merge as kmerge
from repro_torch.models import moe as models_moe
from repro_torch.utils.census import SortCounter, profiler_kernel_counts

# the launch-census test config: small thresholds so every structural
# feature (local-sort classes, multi-pass loop) appears at toy sizes
TCFG = model.SortConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)


# --------------------------------------------------------------------------
# symbolic-parameter helpers (the reference's, on the port's planners)

def hybrid_params(n: int, cfg: model.SortConfig, key_bits: int = 32,
                  key_bytes: int = 4, vals: int = 0,
                  val_bytes: int = 0) -> Dict[str, Any]:
    """Formula environment for the hybrid-sort contract at (n, cfg)."""
    a_max = model.max_active_buckets(n, cfg)
    return {
        "n": n,
        "classes": len(local_sort_classes(n, cfg)),
        "passes": model.num_digits(key_bits, cfg.d),
        "g_max": plan.max_region_blocks(n, cfg.kpb, a_max),
        "B": cfg.step_batch,
        "n_pad": fused.pad_length(n, cfg.kpb),
        "kb": key_bytes, "vb": val_bytes, "vals": vals,
    }


def lsd_params(n: int, d: int, kpb: int, step_batch: int, key_bits: int = 32,
               key_bytes: int = 4, vals: int = 0,
               val_bytes: int = 0) -> Dict[str, Any]:
    """Formula environment for the LSD contract (unrolled, a_max = 1)."""
    return {
        "n": n,
        "passes": model.num_digits(key_bits, d),
        "g_max": plan.max_region_blocks(n, kpb, 1),
        "B": step_batch,
        "n_pad": fused.pad_length(n, kpb),
        "kb": key_bytes, "vb": val_bytes, "vals": vals,
    }


def spp_params(m: int, num_buckets: int, kpb: int = 1024,
               step_batch: int = 8, id_bytes: int = 4) -> Dict[str, Any]:
    """Formula environment for one standalone counting pass
    (``plan.single_pass_partition`` and everything routed through it).
    Mirrors the engine's kpb clamp; the iota permutation is the single
    int32 value leaf."""
    kpb_eff = max(8, min(kpb, 1 << (m - 1).bit_length()))
    return {
        "n": m,
        "passes": 1,
        "g_max": plan.max_region_blocks(m, kpb_eff, 1),
        "B": step_batch,
        "n_pad": fused.pad_length(m, kpb_eff),
        "kb": id_bytes, "vb": 4, "vals": 1,
    }


def merge_params(lens, kway: int, tile: int, key_bytes: int = 4,
                 vals: int = 0, val_bytes: int = 0) -> Dict[str, Any]:
    """Formula environment for one k-way merge round over runs ``lens``."""
    n = int(sum(lens))
    return {
        "n": n, "kway": kway,
        "n_pad": fused.pad_length(n, tile),
        "kb": key_bytes, "vb": val_bytes, "vals": vals,
    }


def dist_params(P: int, n_local: int, chunks: int, attempts: int,
                cfg: model.SortConfig, oversample: int = 64,
                slack: float = 2.0, refine: int = 4, key_bytes: int = 4,
                leaves: int = 0, val_bytes: int = 0) -> Dict[str, Any]:
    """Formula environment for the distributed shard body: the engine's
    per-(source, dest) capacity and the per-attempt gathered sample
    lengths ``samp[a] = chunks * m_a``."""
    chunk = n_local // chunks
    base = slack * chunk / P
    cap = max(1, min(chunk, int(base + 4.0 * math.sqrt(max(base, 1.0)))))
    samp = []
    for a in range(attempts):
        s_a = oversample * (refine ** a)
        m = max(1, min(-(-s_a // chunks), chunk))
        samp.append(chunks * m)
    return {
        "P": P, "chunks": chunks, "attempts": attempts,
        "classes": len(local_sort_classes(chunk, cfg)),
        "cap": cap, "samp": samp,
        "kb": key_bytes, "vb": val_bytes, "leaves": leaves,
    }


def expected_census(name: str, params: Dict[str, Any]) -> Dict[str, Any]:
    """Evaluate a registered contract's census formulas at ``params``."""
    decl = REGISTRY[name].decl["census"]
    return {
        "total": int(expr.evaluate(decl["launch_total"], params)),
        "while_bodies": [int(x) for x in
                         expr.evaluate(decl["while_body_launches"], params)],
    }


# --------------------------------------------------------------------------
# contract records and run recipes

Recipe = Tuple[Callable[[], Any], Callable[[Any], Dict[str, Any]]]


@dataclass(frozen=True)
class Contract:
    """One verified entry point: declaration + run recipe."""
    name: str
    decl: Dict[str, Any]
    make: Callable[[torch.device], Recipe]
    shards: int = 1


def _uint32(seed: int, n: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)) \
        .to(device)


def _ids(seed: int, m: int, buckets: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, buckets, m, dtype=np.int32)) \
        .to(device)


def _executed(params: Dict[str, Any], passes: int, elided=None):
    out = dict(params, passes=passes, executed=passes)
    if elided is not None:
        out["elided"] = elided
    return out


def _mk_hybrid(device) -> Recipe:
    n = 2048
    x = _uint32(1, n, device)
    run = lambda: hybrid_sort(x, cfg=TCFG, engine="kernel",  # noqa: E731
                              return_stats=True)
    return run, lambda out: _executed(hybrid_params(n, TCFG),
                                      out[-1].counting_passes,
                                      out[-1].elided_passes)


def _mk_hybrid_kv(device) -> Recipe:
    n = 1024
    x = _uint32(2, n, device)
    v = _uint32(3, n, device).view(torch.int32)
    run = lambda: hybrid_sort(x, v, cfg=TCFG, engine="kernel",  # noqa: E731
                              return_stats=True)
    return run, lambda out: _executed(
        hybrid_params(n, TCFG, vals=1, val_bytes=4), out[-1].counting_passes,
        out[-1].elided_passes)


def _mk_lsd(device) -> Recipe:
    n, d, kpb, B = 2048, 8, 512, 4
    x = _uint32(4, n, device)
    run = lambda: lsd_sort(x, d=d, engine="kernel", kpb=kpb,  # noqa: E731
                           return_passes=True)
    return run, lambda out: dict(lsd_params(n, d, kpb, B), passes=out[-1])


def _mk_spp(device) -> Recipe:
    m, r = 1000, 8
    ids = _ids(5, m, r, device)
    return (lambda: plan.single_pass_partition(ids, r, engine="kernel"),
            lambda out: spp_params(m, r))


def _mk_moe_dispatch(device) -> Recipe:
    m, e, cap = 512, 8, 64
    ids = _ids(6, m, e, device)
    return (lambda: capacity_dispatch(ids, e, cap, engine="kernel"),
            lambda out: spp_params(m, e))


def _mk_pipeline_bucketing(device) -> Recipe:
    m, r = 600, 256
    ids = _ids(7, m, r, device)
    return (lambda: counting_partition(ids, r, engine="kernel"),
            lambda out: spp_params(m, r))


def _mk_ooc_chunk_sort(device) -> Recipe:
    n = 256
    x = _uint32(8, n, device)
    run = lambda: core_outofcore._sort_chunk(x, (), TCFG,  # noqa: E731
                                             "kernel")
    return run, lambda out: _executed(hybrid_params(n, TCFG), out[2])


def _sorted_runs(seed: int, lens) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.sort(rng.integers(0, 2**32, ln, dtype=np.uint32))
            for ln in lens]


def _carrier(ubits: np.ndarray, length: int, device) -> torch.Tensor:
    """Unsigned ordered bits as the port's signed carrier, padded to
    ``length`` with the all-ones sentinel."""
    buf = torch.full((length,), -1, dtype=torch.int32)
    buf[:ubits.size] = torch.from_numpy(ubits.view(np.int32))
    return buf.to(device)


def _mk_ooc_merge_round(device) -> Recipe:
    lens, kway, tile = (256,) * 4, 4, 64
    n = sum(lens)
    buf = fused.pad_length(n, tile)
    src = _carrier(np.concatenate(_sorted_runs(9, lens)), buf, device)
    alt = torch.full((buf,), -1, dtype=torch.int32, device=device)
    run = lambda: core_outofcore.merge_round(  # noqa: E731
        src, (), alt, (), lens=lens, kway=kway, tile=tile, n=n)
    return run, lambda out: merge_params(lens, kway, tile)


def _mk_ooc_slab_sweep(device) -> Recipe:
    # the §5 spill path: one strip's windows uploaded back to back, padded
    # with the sentinel to the slab buffer, and ONE merge-kernel sweep
    slab, tile, kway = 64, 16, 4
    buf = fused.pad_length(slab, tile)
    runs = _sorted_runs(10, (20, 16, 12))
    (strip,) = kmerge.spill_group_plan(runs, kway, tile, slab)
    up = np.concatenate([r[lo:lo + ln] for r, lo, ln in
                         zip(runs, strip.win_lo, strip.win_len)])
    up_k = _carrier(up, up.size, device)
    tables = tuple(torch.from_numpy(t).to(device) for t in strip.tables)
    alt = torch.full((buf,), -1, dtype=torch.int32, device=device)

    def sweep():
        slab_k = torch.cat([up_k, up_k.new_full((buf - up_k.shape[0],), -1)])
        return kmerge.kway_merge_round(slab_k, (), alt, (), *tables,
                                       kway=kway, tpb=tile, n=slab)

    return sweep, lambda out: merge_params((slab,), kway, tile)


DIST_P = 8


def _dist_recipe(mesh, device) -> Recipe:
    """The distributed shard body over ``mesh``: 512 keys a shard in 2
    chunks, up to 2 attempts; the mesh's held shards of one global input."""
    n_local, chunks, attempts = 512, 2, 2
    fn = core_distributed.make_distributed_sort(
        mesh, cfg=TCFG, engine="kernel", num_chunks=chunks,
        max_attempts=attempts, oversample=64, slack=2.0, refine=4)
    lo, hi = mesh.shards[0], mesh.shards[-1] + 1      # a contiguous range
    x = _uint32(11, mesh.size * n_local, device)[lo * n_local:hi * n_local]
    return (lambda: fn(x),
            lambda out: dist_params(mesh.size, n_local, chunks,
                                    int(out[-1].exchange_attempts[0]), TCFG))


def _mk_distributed(device) -> Recipe:
    return _dist_recipe(core_distributed.LocalMesh(DIST_P, device), device)


CONTRACTS: List[Contract] = [
    Contract("hybrid_sort", core_hybrid.ANALYSIS_CONTRACT, _mk_hybrid),
    Contract("hybrid_sort_kv", core_hybrid.ANALYSIS_CONTRACT, _mk_hybrid_kv),
    Contract("lsd_sort", core_lsd.ANALYSIS_CONTRACT, _mk_lsd),
    Contract("single_pass_partition", plan.ANALYSIS_CONTRACT, _mk_spp),
    Contract("moe_dispatch", models_moe.ANALYSIS_CONTRACT, _mk_moe_dispatch),
    Contract("pipeline_bucketing", data_pipeline.ANALYSIS_CONTRACT,
             _mk_pipeline_bucketing),
    Contract("ooc_chunk_sort",
             core_outofcore.ANALYSIS_CONTRACTS["ooc_chunk_sort"],
             _mk_ooc_chunk_sort),
    Contract("ooc_merge_round",
             core_outofcore.ANALYSIS_CONTRACTS["ooc_merge_round"],
             _mk_ooc_merge_round),
    Contract("ooc_slab_sweep",
             core_outofcore.ANALYSIS_CONTRACTS["ooc_slab_sweep"],
             _mk_ooc_slab_sweep),
    Contract("distributed_shard", core_distributed.ANALYSIS_CONTRACT,
             _mk_distributed, shards=DIST_P),
]
REGISTRY: Dict[str, Contract] = {c.name: c for c in CONTRACTS}


# --------------------------------------------------------------------------
# the runner

@dataclass
class ContractReport:
    """Per-contract findings, keyed by check name (empty lists = green)."""
    name: str
    checks: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(self.checks.values())

    @property
    def findings(self) -> List[str]:
        return [f"{self.name}/{check}: {msg}"
                for check, msgs in self.checks.items() for msg in msgs]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ok": self.ok, "checks": self.checks}


def _device(device) -> torch.device:
    """``None`` is the card (raising without one); else as given."""
    return interop.resolve_device(device)


def check_run(name: str, decl: Dict[str, Any], rec, sorts, params,
              *, shards: int = 1, device: str = "cpu", profiled=None,
              device_names=None) -> ContractReport:
    """Every declared check on one recorded run."""
    checks: Dict[str, List[str]] = {}
    if "census" in decl:
        checks["census"] = _census.check_census(
            rec, decl["census"], params, scale=shards, device=device,
            profiled=profiled, device_names=device_names)
    if decl.get("sort_free"):
        checks["sort_free"] = (
            [] if sorts.sorts == 0 else
            [f"{sorts.sorts} sort op(s) in a sort-free entry point, at "
             f"{sorted(set(sorts.sites))}"])
    checks["donation"] = _donation.check_donation(
        rec.records, decl.get("donation"), params)
    if "transfer" in decl:
        checks["transfer.hbm_bytes"] = _transfer.check_hbm_bytes(
            rec.records, decl["transfer"], params)
    if "link" in decl:
        checks["transfer.link_bytes"] = _transfer.check_link_bytes(
            _transfer.recorded_link(rec), decl["link"], params)
    hazard: List[str] = []
    for r in rec.records:
        hazard.extend(r.written_once or ())
    if rec.hazard:
        missed = {r.name for r in rec.records if r.name in REPLAYED} - \
            {r.name for r in rec.records if r.written_once is not None}
        hazard.extend(f"{k}: launched but never replayed" for k in
                      sorted(missed))
    checks["hazard"] = hazard
    return ContractReport(name, checks)


def run_contract(contract: Contract, device=None) -> ContractReport:
    """Run one entry point once under the recorder (with write replays)
    and the sort counter — on the card also under the profiler — and
    check every declaration."""
    dev = _device(device)
    run, params_of = contract.make(dev)
    profiled = names = None
    with recording(hazard=True) as rec, SortCounter() as sorts:
        if dev.type == "cuda":
            out, profiled, names = profiler_kernel_counts(run)
        else:
            out = run()
    return check_run(contract.name, contract.decl, rec, sorts,
                     params_of(out), shards=contract.shards,
                     device=dev.type, profiled=profiled, device_names=names)


def run_mesh_contract(mesh) -> ContractReport:
    """The ``distributed_shard`` contract on one rank of a
    ``ProcessGroupMesh``: the rank's own census (one shard) from the
    recorder, its collectives' sites and wire bytes from
    ``utils.collectives.CollectiveMode``."""
    from repro_torch.utils.collectives import CollectiveMode
    contract = REGISTRY["distributed_shard"]
    run, params_of = _dist_recipe(mesh, mesh.device)
    with recording(hazard=True) as rec, SortCounter() as sorts, \
            CollectiveMode() as mode:
        out = run()
    params = params_of(out)
    report = check_run(contract.name, contract.decl, rec, sorts, params,
                       device=mesh.device.type)
    report.checks["transfer.link_bytes"] = _transfer.check_link_bytes(
        _transfer.mode_link(mode), contract.decl["link"], params)
    return report


def table_checks(device=None) -> Dict[str, List[str]]:
    """Interval checks on descriptor-table instances from the port's
    planners (fused region blocks, merge-path tiles, host-spill strips),
    and one merge round over the merge tables replayed with an ``arange``
    leaf: every lane written exactly once."""
    dev = _device(device)
    out: Dict[str, List[str]] = {}

    m, kpb, B = 1000, 128, 4
    blocks = plan.make_region_blocks(
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.full((1,), m, dtype=torch.int32, device=dev), m, kpb,
        plan.max_region_blocks(m, kpb, 1), batch=B)
    out["hazard.fused_tables"] = refhazard.check_fused_tables(
        blocks, m, kpb, fused.pad_length(m, kpb))

    lens, kway, tile = (64, 48, 32, 16, 40), 4, 16
    n = int(sum(lens))
    buf = fused.pad_length(n, tile)
    keys = _carrier(np.concatenate([np.arange(ln, dtype=np.uint32)
                                    for ln in lens]), buf, dev)
    tables = kmerge.merge_path_partition(keys, lens, kway, tile)
    out["hazard.merge_tables"] = refhazard.check_merge_tables(
        *tables, kway=kway, tpb=tile, n=n, buf_len=buf)
    alt = torch.full_like(keys, -1)
    out["hazard.merge_written_once"] = refhazard.replay_written_once(
        "_kway_merge_kernel",
        (kmerge.kway_merge_round, (keys, (), alt, (), *tables),
         dict(kway=kway, tpb=tile, n=n)))

    runs = [np.arange(ln, dtype=np.uint32) for ln in (100, 37, 23)]
    tile, slab = 16, 32
    spill: List[str] = []
    for strip in kmerge.spill_group_plan(runs, 4, tile, slab):
        spill.extend(refhazard.check_merge_tables(
            *strip.tables, kway=4, tpb=tile, n=strip.out_len,
            buf_len=fused.pad_length(slab, tile)))
    out["hazard.spill_tables"] = spill
    return out


def run_all(device=None) -> List[ContractReport]:
    """The full sweep: every registered contract + the table instances."""
    dev = _device(device)
    reports = [run_contract(c, dev) for c in CONTRACTS]
    reports.append(ContractReport("descriptor_tables", table_checks(dev)))
    return reports
