"""Launch-census verification against the symbolic contract formulas.

The structural headline of §4.3–§4.4 — ONE fused launch per counting pass,
one merge launch per round — is declared next to each engine as formulas in
(passes, rounds, classes, attempts, chunks) and checked here against a
recorded run (``trace.Recorder``):

  * ``launch_total`` against the census that counts each pass loop once, at
    its body (``utils.census.launch_census``), and ``while_body_launches``
    against each loop's largest per-iteration count;
  * the run itself: every executed pass is one fused launch and every
    elided pass none (``executed`` / ``elided`` of the parameters, where
    the entry point reports them), so the run launches ``launch_total -
    sum(while_body_launches) + executed`` kernels (``1 + passes +
    classes`` for the hybrid sort);
  * ``fused_grid``: the descriptor tables' rows, in whole super-steps of
    ``B`` rows — ``ceil_div(rows, B)`` against the formula (the port's
    tables are flat; the reference's batched grid is their row count over
    ``B``);
  * on the card, no launch may have run a plain version, and every kernel's
    launches equal ``torch.profiler``'s count of its device kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis import expr
from repro_torch.utils import census as ucensus


def check_census(rec, decl: Dict, params: Dict, *, scale: int = 1,
                 device: str = "cpu",
                 profiled: Optional[Dict[str, int]] = None,
                 device_names: Optional[Dict[str, int]] = None) -> List[str]:
    """Census findings of one recorded run (empty = green).

    ``scale`` repeats the per-shard formulas for a run that holds that many
    shards (``LocalMesh``); ``profiled`` is the profiler's per-kernel count
    of the same run (on the card) and ``device_names`` every device entry
    it traced, named in a finding when the counts differ."""
    findings: List[str] = []
    got = ucensus.launch_census(rec)

    want_total = scale * int(expr.evaluate(decl["launch_total"], params))
    if got["total"] != want_total:
        findings.append(
            f"launch total {got['total']} != declared "
            f"{decl['launch_total']!r} = {want_total}")

    want_while = scale * [int(x) for x in
                          expr.evaluate(decl["while_body_launches"], params)]
    if got["while_bodies"] != want_while:
        findings.append(
            f"while-body launches {got['while_bodies']} != declared "
            f"{decl['while_body_launches']!r} = {want_while}")

    if "executed" in params:
        # one fused launch per executed pass, none per elided one
        loops = rec.while_loops()
        ran = sum(sum(lp.counts) for lp in loops)
        idle = sum(c == 0 for lp in loops for c in lp.counts)
        if ran != params["executed"] or \
                idle != params.get("elided", idle):
            findings.append(
                f"pass loops launched {ran} time(s) with {idle} idle "
                f"iteration(s); the run reports {params['executed']} "
                f"executed and {params.get('elided', '?')} elided pass(es)")
        want_runs = want_total - sum(want_while) + params["executed"]
        if got["launches"] != want_runs:
            findings.append(
                f"{got['launches']} launches in the run, declared "
                f"{decl['launch_total']!r} with each loop body run once per "
                f"executed pass = {want_runs}")

    if "fused_grid" in decl:
        want_grid = int(expr.evaluate(decl["fused_grid"], params))
        b = int(params["B"])
        tables = ucensus.grid_sizes(rec)
        if not tables:
            findings.append("fused_grid declared but no _fused_pass_kernel "
                            "launch recorded")
        for shape in tables:
            rows = 1
            for d in shape:
                rows *= d
            if -(-rows // b) != want_grid:
                findings.append(
                    f"_fused_pass_kernel: {rows} descriptor rows make "
                    f"{-(-rows // b)} super-steps of {b}, declared "
                    f"{decl['fused_grid']!r} = {want_grid}")

    if device != "cpu":
        plain = sorted({r.name for r in rec.records if r.plain})
        if plain:
            findings.append(f"plain versions ran on {device}: {plain}")
    if profiled is not None:
        want = ucensus.grouped(rec.counts())
        for name, c in ucensus.grouped(rec.hidden).items():
            want[name] = want.get(name, 0) + c
        if want != profiled:
            other = sorted(n for n in (device_names or {})
                           if ucensus.kernel_group(n) is None)
            findings.append(f"recorded launches {want} != the profiler's "
                            f"{profiled} (its other device entries: "
                            f"{other[:12]})")
    return findings
