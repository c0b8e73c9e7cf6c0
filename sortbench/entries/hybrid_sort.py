"""Entry ``hybrid_sort``: the port's hybrid radix sort, called as a
database operator calls it, with keys and values and nothing else.  Which
``SortConfig`` and which engine run is the program's choice.  The inputs
stay where the generator made them, on the card."""
from __future__ import annotations

from pathlib import Path

import repro_torch.kernels as _kernels
from repro_torch.core import hybrid_sort as _hybrid_sort
from repro_torch.core import model as _model
from repro_torch.kernels import _build

from sortbench import devtrace


def call(inp: dict, config: dict) -> dict:
    if "values" in inp:
        keys, values = _hybrid_sort(inp["keys"], inp["values"])
        return {"keys": keys, "values": values}
    return {"keys": _hybrid_sort(inp["keys"])}


def describe(inp: dict, config: dict) -> dict:
    """What the program chooses for these inputs, as far as it says: the
    config ``hybrid_sort`` takes when given none."""
    key_bytes = inp["keys"].element_size()
    return {"entry": "repro_torch.core.hybrid_sort(keys, values)",
            f"model.default_config({key_bytes})":
                repr(_model.default_config(key_bytes))}


def stats(inp: dict, config: dict) -> dict:
    """The program's own counts for one call (it adds a bincount over the
    records and a host read, so it runs outside every window)."""
    args = (inp["keys"], inp["values"]) if "values" in inp else \
        (inp["keys"],)
    st = _hybrid_sort(*args, return_stats=True)[-1]
    return st._asdict()


def counters() -> dict:
    """The program's own counts so far: its kernel launches (one count per
    launch in each wrapper) and the sort loop's host reads."""
    counts = dict(_build.COUNTS)
    reads = counts.pop("host_reads")
    return {"kernel_launches": sum(counts.values()), "host_reads": reads}


def kernel_names() -> set:
    """The device names of every kernel the program can launch."""
    return devtrace.port_kernel_names(Path(_kernels.__file__).parent)
