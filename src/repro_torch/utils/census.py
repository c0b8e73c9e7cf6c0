"""Launch and op census: the port's counterpart of the census half of
``repro.utils.hlo``.

The reference reads its census off lowered text and traced jaxprs.  The
port has neither, so it counts what runs:

  * :func:`op_counts` / :func:`sort_op_count` — a dispatch mode over one
    call: a histogram of the aten ops it ran, and the ops among them that
    sort (``sort``, ``argsort``, ``msort``, a ``unique`` with
    ``sorted=True``).  Ops called from ``kernels/ref.py`` — the declared
    oracle, which also holds the CPU plain versions — are not counted as
    sorts: the sort-free claim is about the kernel engines;
  * :func:`kernel_launch_count`, :func:`while_body_launches`,
    :func:`launch_census`, :func:`grid_sizes` — read a launch recorder
    (``repro_torch.analysis.trace.Recorder``): every launch of a kernel the
    reference writes in Pallas, the largest per-iteration count of each
    pass loop, and the descriptor tables' shape of each fused launch;
  * :func:`profiler_kernel_counts` — ``torch.profiler``'s count of each
    port ``__global__`` kernel over one call, on the card, grouped by the
    recorder's names, to hold the recorder against the device.
"""
from __future__ import annotations

import os
import re
import sys
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SORT_OPS = frozenset({"sort", "argsort", "msort"})
#: aten's unique ops and the position of their ``sorted`` argument
UNIQUE_OPS = {"_unique": 1, "_unique2": 1, "unique_dim": 2}
_REF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "ref.py")


def is_sort(func, args, kwargs) -> bool:
    """Whether an aten op sorts."""
    name = func.overloadpacket.__name__
    if name in SORT_OPS:
        return True
    if name in UNIQUE_OPS:
        at = UNIQUE_OPS[name]
        return bool(kwargs.get("sorted", args[at] if len(args) > at
                               else True))
    return False


def _frames():
    f = sys._getframe(2)
    while f is not None:
        yield f
        f = f.f_back


def _in_plain_version() -> bool:
    """Whether the running op was called from ``kernels/ref.py``."""
    return any(os.path.abspath(f.f_code.co_filename) == _REF
               for f in _frames())


def _caller() -> str:
    """``file:line`` of the op's first caller outside torch."""
    for f in _frames():
        path = os.path.abspath(f.f_code.co_filename)
        if path != os.path.abspath(__file__) and \
                f"{os.sep}torch{os.sep}" not in path:
            return f"{path}:{f.f_lineno}"
    return "?"


class SortCounter(TorchDispatchMode):
    """Counts the sorting aten ops run outside the plain versions
    (``sorts``, with each caller in ``sites``) and every aten op by name
    (``ops``)."""

    def __init__(self):
        super().__init__()
        self.sorts = 0
        self.sites: List[str] = []
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        if is_sort(func, args, kwargs) and not _in_plain_version():
            self.sorts += 1
            self.sites.append(_caller())
        return func(*args, **kwargs)


def op_counts(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Histogram of the aten ops one call of ``fn`` runs."""
    with SortCounter() as sc:
        fn(*args, **kwargs)
    return dict(sc.ops)


def sort_op_count(fn: Callable, *args, **kwargs) -> int:
    """Sorting aten ops in one call of ``fn``, the plain versions' aside:
    0 certifies a kernel engine sort-free."""
    with SortCounter() as sc:
        fn(*args, **kwargs)
    return sc.sorts


# ----- the launch census (read off a recorder) ------------------------------

def kernel_launch_count(rec) -> int:
    """Launches of the kernels the reference writes in Pallas."""
    return len(rec.pallas())


def while_body_launches(rec) -> List[int]:
    """Each pass loop's largest per-iteration launch count, in the order
    the loops opened (the reference's per-while-body census)."""
    return [lp.body for lp in rec.while_loops()]


def launch_census(rec) -> Dict[str, Any]:
    """``{"total", "while_bodies", "launches"}``: ``total`` counts each
    pass loop once, at its body (the reference's static census); the
    run's own launch count is ``launches``."""
    bodies = while_body_launches(rec)
    outside = sum(1 for r in rec.pallas() if not r.in_while)
    return {"total": outside + sum(bodies), "while_bodies": bodies,
            "launches": kernel_launch_count(rec)}


def grid_sizes(rec) -> List[Tuple[int, ...]]:
    """The descriptor tables' shape of every fused launch, in order."""
    return [r.tables for r in rec.records if r.name == "_fused_pass_kernel"]


# ----- the profiler's count -------------------------------------------------

#: a port ``__global__`` name -> the recorder's name for it, matched in the
#: demangled form (``void hist_kernel<int, true>(...)``) and in the mangled
#: one (``_ZN...11hist_kernelIiLb1EEv...``); the row network's and the
#: multisplit's kernels serve two entry points each, which share one name
_GLOBALS = (
    (r"merge_rows_kernel", "merge_rows"),
    (r"hist_kernel|split_total_kernel", "_hist_kernel"),
    (r"fused_pass_kernel|fused_wide_kernel", "_fused_pass_kernel"),
    (r"segments_kernel", "_bitonic_stable_kernel"),
    (r"rows_kernel.*Fmt", "_bitonic_kernel|_bitonic_kv_kernel"),
    (r"rows_kernel", "_bitonic_stable_kernel"),
    (r"kway_merge_kernel|merge_small", "_kway_merge_kernel"),
    (r"multisplit_kernel", "_multisplit_kernel|_multisplit_kv_kernel"),
    (r"assigned_kernel", "_assigned_hist_kernel"),
)


def kernel_group(name: str):
    """The recorder's name of a port kernel's device name, or None."""
    for pattern, group in _GLOBALS:
        if re.search(pattern, name):
            return group
    return None


def grouped(counts: Dict[str, int]) -> Dict[str, int]:
    """A recorder's per-name counts merged as :func:`kernel_group` merges
    the device names (the two-entry kernels under one name)."""
    out: Dict[str, int] = {}
    for name, c in counts.items():
        key = next((g for _, g in _GLOBALS if name in g.split("|")), name)
        out[key] = out.get(key, 0) + c
    return out


def profiler_kernel_counts(fn: Callable, *args, **kwargs):
    """``(result, {name: launches}, {device name: events})``: one call of
    ``fn`` under ``torch.profiler`` (CPU and CUDA activity) on the card,
    the port's kernels counted by the recorder's names (see
    :func:`grouped`), and every device entry of the trace by its own
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
    counts: Dict[str, int] = {}
    names: Dict[str, int] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        names[evt.name] = names.get(evt.name, 0) + 1
        group = kernel_group(evt.name)
        if group is not None:
            counts[group] = counts.get(group, 0) + 1
    return out, counts, names
