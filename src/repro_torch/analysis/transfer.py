"""Transfer accounting: sweep bytes from the recorded buffers, diffed
against the declared tables.

The §4.3/§4.4 tables in ``kernels/__init__`` claim a sort with p executed
passes moves exactly ``(2p + 1)·n_pad·kb + 2p·n_pad·vb`` bytes (prologue
and passes) and a merge round ``2·n_pad·(kb + vb)``.  This pass re-derives
those numbers from the launches of a run: for every launch of a declared
sweep kernel, each buffer of exactly ``n_pad`` elements that it reads is one
read sweep, and each such buffer that it writes without reading it is one
write sweep (a buffer written in place is an accumulator, not a sweep).
The total must equal the declared formula exactly — no tolerance — with
``passes`` the run's executed passes: every executed pass is a launch of
its own, so there is no nominal multiplier as in the reference's traced
loop body.

Link traffic is the wire bytes and site counts of the collectives: reported
by ``LocalMesh`` to the recorder, or counted by
``utils.collectives.CollectiveMode`` on a process group (the reference's
wire weights in both), against the link table's formulas.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.analysis import expr

#: a process group's collective kinds under the reference's primitive names
_KINDS = {"all-to-all": "all_to_all", "all-gather": "all_gather",
          "all-reduce": "psum"}


def record_sweeps(rec, n_pad: int) -> Dict[str, List]:
    """The n_pad-sized read and write sweeps of one launch."""
    read_ptrs = {b.ptr for b in rec.reads}
    reads = [b for b in rec.reads if b.numel == n_pad]
    writes = [b for b in rec.writes
              if b.numel == n_pad and b.ptr not in read_ptrs]
    return {"reads": reads, "writes": writes}


def derive_hbm_bytes(recs, decl: Dict, params: Dict) -> Dict:
    """Sum sweep bytes over the declared sweep kernels of a run."""
    n_pad = int(params["n_pad"])
    kernels = set(decl["sweep_kernels"])
    total = 0
    per = []
    for rec in recs:
        if rec.name not in kernels:
            continue
        sw = record_sweeps(rec, n_pad)
        nbytes = sum(b.nbytes for b in sw["reads"] + sw["writes"])
        total += nbytes
        per.append({"kernel": rec.name, "iteration": rec.iteration,
                    "reads": len(sw["reads"]), "writes": len(sw["writes"]),
                    "bytes": nbytes})
    return {"total": total, "launches": per}


def check_hbm_bytes(recs, decl: Dict, params: Dict) -> List[str]:
    derived = derive_hbm_bytes(recs, decl, params)
    want = int(expr.evaluate(decl["bytes"], params))
    findings = []
    if derived["total"] != want:
        findings.append(
            f"derived sweep bytes {derived['total']} != declared "
            f"{decl['bytes']!r} = {want} (launches: {derived['launches']})")
    if not derived["launches"]:
        findings.append("no sweep-kernel launch found for transfer "
                        "accounting")
    return findings


def recorded_link(rec):
    """(per-kind wire bytes with 'total', per-kind site counts) of the
    collectives a ``LocalMesh`` reported: per shard, as the reference's
    per-device accounting."""
    bytes_by: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for c in rec.collectives:
        bytes_by[c.kind] = bytes_by.get(c.kind, 0.0) + c.wire_bytes
        counts[c.kind] = counts.get(c.kind, 0) + 1
    bytes_by["total"] = sum(bytes_by.values())
    return bytes_by, counts


def mode_link(mode):
    """The same pair from a ``CollectiveMode`` of one process-group rank."""
    bytes_by = {_KINDS.get(k, k): v for k, v in mode.bytes.items()
                if mode.counts[k]}
    counts = {_KINDS.get(k, k): v for k, v in mode.counts.items() if v}
    bytes_by["total"] = sum(bytes_by.values())
    return bytes_by, counts


def check_link_bytes(link, decl: Dict, params: Dict) -> List[str]:
    """Diff wire bytes / site counts against the link table's formulas."""
    bytes_by, counts = link
    findings: List[str] = []
    for kind, formula in decl.get("collective_counts", {}).items():
        want = int(expr.evaluate(formula, params))
        got = counts.get(kind, 0)
        if got != want:
            findings.append(
                f"{kind} site count {got} != declared {formula!r} = {want}")
    if "link_bytes" in decl:
        want = float(expr.evaluate(decl["link_bytes"], params))
        got = bytes_by.get("total", 0.0)
        if not math.isclose(got, want, rel_tol=1e-9, abs_tol=0.5):
            findings.append(
                f"derived wire bytes {got} != declared formula = {want} "
                f"(by kind: {bytes_by})")
    return findings
