"""The program's own spans of the traced window, for the per-layer readers
that read them.

While a profiler records, the program keeps the spans of each whole sort
in memory (``repro_torch.core.spans.LOG``): a ``hybrid_sort`` span per
call holding its prologue, passes (``p``, ``executed``,
``active_records``), reads, plan, scatter, local sort (``records``) and
epilogue.  The harness profiles only its traced window, so the sorts this
run logged before its timed window are the traced calls.  A program
without the log (an older commit), a run that never called the program (a
control) and sorts that ran on no device give nothing to read.
"""
from __future__ import annotations

from pathlib import Path


def traced_sorts(run):
    """Each sort of the traced window as its list of spans (the sort's own
    span first), or None where there is none to read.  Raises where their
    number is not the trace's number of calls."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    start_ns = (run.window.start - run.setup_s) * 1e9
    end_ns = run.window.start * 1e9
    sorts = [s for s in spans.LOG.sorts()
             if start_ns <= s[0]["start_ns"] <= end_ns]
    if not sorts or sorts[0][0]["stream_ms"] is None:
        return None
    calls = run.traced.trace.n_calls
    if len(sorts) != calls:
        raise RuntimeError(
            f"the program logged {len(sorts)} sorts before the timed window, "
            f"the trace holds {calls} calls: the span log does not cover the "
            f"traced window, and readings from it would be wrong")
    return sorts


def named(sorts, name: str) -> list:
    """Every span called ``name`` in ``sorts``."""
    return [s for sort in sorts for s in sort if s["name"] == name]


def executed_passes(sorts) -> list:
    """``(active_records, n)`` of each pass that ran its fused launch."""
    return [(s["attrs"]["active_records"], sort[0]["attrs"]["n"])
            for sort in sorts for s in sort
            if s["name"] == "hybrid_sort.pass" and s["attrs"]["executed"]]


def local_sort_source() -> Path:
    """The CUDA source of the program's local sort."""
    import repro_torch.kernels as kernels
    return Path(kernels.__file__).parent / "csrc" / "local_sort.cu"
