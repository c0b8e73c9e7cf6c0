"""One run of one cell: set-up, the windows, the check and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (a JSON file of its columns and sizes, naming an
``entry`` and a ``reference``) and its traffic mix (``traffic/<name>.json``); each metric
is read by ``metrics/<name>.py``.  The harness holds no cell, mix, entry
or metric of its own.  Both the entry and the reference get the
configuration with every input.

A run (``run``):

1. makes the inputs on the device from the seed (``generate``), lets the
   entry place them where it takes them (its optional ``prepare``), warms
   the entry up on each of them, then runs the window's loop for a few
   calls (``timed_window``) holding the outputs the window holds, so that
   no allocation waits in the window;
2. with ``trace``, profiles ``TRACED_CALLS`` calls (``traced_window``);
3. calls the entry back to back for ``seconds`` seconds, each call ending
   in a synchronize, alternating the inputs (``timed_window``), and keeps
   the outputs of a seed-drawn early call and of the last call on each
   input;
4. frees the program's state, runs the reference on each input and
   compares every kept output with it (``check``);
5. reads the metrics and returns the result line.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from sortbench import devtrace, generate, roofline

HERE = Path(__file__).resolve().parent
#: top-level module names the process that prints a result may not hold:
#: the JAX stack, the JAX package and its benchmark harness
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: calls in the profiled window of a traced run
TRACED_CALLS = 6
#: each input's kept early output is one of its first this many calls
EARLY_CALLS = 3


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the harness, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"sortbench.{kind}." + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """A cell with its configuration, traffic mix and the metrics it
    reads (end-to-end ones without ``trace``, per-layer ones with): each
    metric whose ``workloads``, where it has them, list the cell.  A
    reader that finds nothing to read in a cell leaves its metric out."""

    def __init__(self, cell: dict, config: dict, traffic: dict,
                 end_to_end: list, per_layer: list):
        self.cell, self.config, self.traffic = cell, config, traffic
        name = cell["name"]
        self.end_to_end, self.per_layer = (
            [m for m in ms if name in m.get("workloads", [name])]
            for ms in (end_to_end, per_layer))


def load_spec(root: Path, workload: str) -> Spec:
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    return Spec(cell, config, traffic, bench["end_to_end"],
                bench.get("per_layer", []))


# ----- the device ----------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in BANNED_MODULES})


def host_readings(device: torch.device) -> dict:
    """Counters read around the timed window: the clock, this process's
    CPU seconds and the allocator's device allocations."""
    t = os.times()
    out = {"t": time.perf_counter(), "user_s": t.user, "sys_s": t.system}
    if device.type == "cuda":
        ms = torch.cuda.memory_stats(device)
        out["device_allocs"] = ms.get("num_device_alloc", 0)
        out["alloc_retries"] = ms.get("num_alloc_retries", 0)
    return out


def host_summary(before: dict, after: dict, walls: list) -> dict:
    """What the host did over the timed window (printed, not a metric):
    its calls, their median and longest walls, the calls over 1.5 times
    the median (the first few by index) and the seconds they took beyond
    it, this process's CPU seconds, and the device allocations the
    window waited for."""
    d = {k: after[k] - before[k] for k in after}
    med = statistics.median(walls)
    slow = [i for i, x in enumerate(walls) if x > 1.5 * med]
    return {"window_s": d.pop("t"), "calls": len(walls),
            "median_ms": 1e3 * med, "max_ms": 1e3 * max(walls),
            "slow_calls": len(slow), "slow_at": slow[:8],
            "slow_excess_s": sum(walls[i] - med for i in slow), **d}


# ----- the windows ---------------------------------------------------------

class Window:
    """The timed window: each call's host wall (seconds), its peak device
    bytes above what was held before it, and the kept outputs."""

    def __init__(self):
        self.walls: list = []
        self.peaks: list = []
        self.memory_peak = 0
        self.start = self.end = 0.0
        self.kept: dict = {}
        self.host: dict = {}

    @property
    def seconds(self) -> float:
        return self.end - self.start


def timed_window(call, inputs: list, seconds: float, seed: int,
                 device: torch.device, min_calls: int = 0) -> Window:
    """Back-to-back calls for ``seconds`` seconds (the call running at the
    deadline finishes and counts), at least one on each input and at
    least ``min_calls`` in all."""
    cuda = device.type == "cuda"
    rng = random.Random(seed)
    early = [rng.randrange(EARLY_CALLS) for _ in inputs]
    kept = {j: [] for j in range(len(inputs))}
    last = {}
    w = Window()
    i, deadline = 0, math.inf
    host = host_readings(device)
    while True:
        j = i % len(inputs)
        if cuda:
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        if i == 0:
            w.start, deadline = t0, t0 + seconds
        out = call(inputs[j])
        _sync(device)
        t1 = time.perf_counter()
        w.walls.append(t1 - t0)
        if cuda:
            peak = torch.cuda.max_memory_allocated(device)
            w.peaks.append(peak - before)
            w.memory_peak = max(w.memory_peak, peak)
        if i // len(inputs) == early[j]:
            kept[j].append(out)
        else:
            last[j] = out
        del out
        i += 1
        if t1 >= deadline and i >= max(len(inputs), min_calls):
            break
    w.end = t1
    w.host = host_summary(host, host_readings(device), w.walls)
    for j, out in last.items():
        kept[j].append(out)
    w.kept = kept
    return w


class Traced:
    """The profiled window: its trace and the program's counts over it."""

    def __init__(self, trace: devtrace.DeviceTrace, counts: dict):
        self.trace, self.counts = trace, counts


def traced_window(entry, call, inputs: list, device: torch.device,
                  calls: int = TRACED_CALLS) -> Traced:
    """``calls`` calls under ``torch.profiler``, each in a call span.  The
    profiler has to see every kernel launch the program counted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = entry.counters()
    _sync(device)
    with profile(activities=acts) as prof:
        for i in range(calls):
            with record_function(devtrace.CALL_SPAN):
                out = call(inputs[i % len(inputs)])
                _sync(device)
            del out
    after = entry.counters()
    counts = {k: after[k] - before[k] for k in after}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = devtrace.load_chrome_trace(path)
    trace = devtrace.DeviceTrace(events, entry.kernel_names())
    seen = trace.port_kernel_launches()
    if seen != counts["kernel_launches"]:
        raise RuntimeError(
            f"the profiler saw {seen} launches of the program's kernels, the "
            f"program counted {counts['kernel_launches']}: the trace lost "
            f"events, and its per-layer readings would be wrong")
    return Traced(trace, counts)


# ----- the check -----------------------------------------------------------

def check(ref, config: dict, inputs: list, kept: dict) -> tuple:
    """Compare every kept output with the reference's output for its
    input: ``(sums of each compared number, outputs wrong, outputs
    checked)``."""
    totals, failed, checked = {}, 0, 0
    for j, outs in kept.items():
        want = ref.reference(inputs[j], config)
        for out in outs:
            got = ref.compare(out, want)
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
            failed += any(got[k] > ref.LIMITS[k] for k in got)
            checked += 1
        del want
    return totals, failed, checked


# ----- the run -------------------------------------------------------------

class Run:
    """What the metric readers read."""

    def __init__(self, spec: Spec, inputs: list, device: torch.device):
        self.spec = spec
        self.records = int(spec.config["records"])
        self.input_bytes = generate.input_bytes(inputs[0])
        self.record_bytes = self.input_bytes // self.records
        self.device_kind = device_kind(device)
        self.bandwidth = roofline.peak_bandwidth(self.device_kind)
        self.setup_s = None
        self.window: Window = None
        self.traced: Traced = None


def _print(obj, file=None) -> None:
    print(json.dumps(obj), file=file or sys.stdout, flush=True)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device="cuda",
        call=None, t_start: float = None) -> dict:
    """One run; ``call`` replaces the entry's ``call(inp, config)`` (for
    controls and planted faults).  Returns the result line."""
    marks = [("start", time.perf_counter() if t_start is None else t_start),
             ("imports", time.perf_counter())]
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        marks.append(("cuda_init", time.perf_counter()))
    config = spec.config
    entry = load_module("entries", config["entry"])
    ref = load_module("references", config["reference"])
    marks.append(("program_import", time.perf_counter()))
    call = call or entry.call
    timed_call = lambda inp: call(inp, config)          # noqa: E731
    inputs = generate.make_inputs(config, spec.traffic, seed, device,
                                  load_module)
    if hasattr(entry, "prepare"):
        inputs = entry.prepare(inputs, config)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    described = entry.describe(inputs[0], config) \
        if hasattr(entry, "describe") else {}
    _print({"cell": spec.cell["name"], "seed": seed, "records":
            config["records"], "inputs": len(inputs), **described})
    for j, inp in enumerate(inputs):                 # warm-up
        timed_call(inp)
        _sync(device)
        marks.append((f"warmup_{j}", time.perf_counter()))
    # the window's own loop, holding the outputs it will hold, so that the
    # allocator owns every block the window takes before the clock starts
    timed_window(timed_call, inputs, 0.0, seed, device,
                 min_calls=len(inputs) * (EARLY_CALLS + 1))
    marks.append(("rehearsal", time.perf_counter()))
    rec = Run(spec, inputs, device)
    if trace:
        rec.traced = traced_window(entry, timed_call, inputs, device)
    rec.window = timed_window(timed_call, inputs, seconds, seed, device)
    marks.append(("traced_window" if trace else "to_window",
                  rec.window.start))
    rec.setup_s = rec.window.start - marks[0][1]
    _print({"setup_parts_s": {b[0]: b[1] - a[1]
                              for a, b in zip(marks, marks[1:])}})
    _print({"window_host": rec.window.host})
    memory_peak = rec.window.memory_peak
    if call is entry.call and hasattr(entry, "stats"):
        _print({"program_stats": entry.stats(inputs[0], config)})
    if device.type == "cuda":
        _print({"card": power_limit()})
        torch.cuda.empty_cache()
    totals, failed, checked = check(ref, config, inputs, rec.window.kept)
    rec.window.kept = {}
    found = banned_modules()
    if found:
        raise SystemExit("modules of the JAX stack or package are loaded: "
                         + ", ".join(found))
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = {k: ref.LIMITS[k] for k in totals}
    correct = (checked >= len(inputs) and failed == 0 and
               all(totals[k] <= limits[k] for k in totals))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": rec.device_kind, "count": int(spec.cell.get("chips", 1)),
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(rec.window.walls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        tr = rec.traced.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["outputs_checked"] = checked
    result["checks"] = {k: {"value": totals[k], "limit": limits[k]}
                        for k in totals}
    for k in totals:
        print(f"{k} {totals[k]} limit {limits[k]}", file=sys.stderr)
    return result
