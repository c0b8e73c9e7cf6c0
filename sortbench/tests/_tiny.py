"""Tiny cells for the CPU tests: a cell of ``BENCHMARK.json`` with its
record count cut so that a run on the CPU takes about a second."""
from __future__ import annotations

from sortbench import harness

ROOT = harness.HERE.parent
RECORDS = 6000


def tiny_spec(workload: str, records: int = RECORDS) -> harness.Spec:
    spec = harness.load_spec(ROOT, workload)
    spec.config = dict(spec.config, records=records)
    return spec


def tiny_run(workload: str, seed: int = 2**33 + 17, trace: bool = False,
             call=None, seconds: float = 0.2, records: int = RECORDS) -> dict:
    return harness.run(tiny_spec(workload, records), seed, seconds, trace,
                       "cpu", call=call)
