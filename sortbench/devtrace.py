"""Reading a ``torch.profiler`` trace of the traced window.

The window is a run of calls, each inside one ``record_function`` span
(``CALL_SPAN``) and each ending in a synchronize, so every device event
of a call lies inside that call's span on the trace's clock.  From the
exported Chrome trace this keeps:

* ``calls``: the spans, in order;
* ``device``: kernels, copies and memsets (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), each with the call it falls in and
  whether it is a kernel of the port's own CUDA libraries;
* ``host``: the host's operators and runtime calls, to name what the host
  was doing while the device sat idle.

The port's kernels are known by name: every ``__global__`` function in the
CUDA sources under ``repro_torch/kernels`` and every ``@triton.jit``
function in its Python sources, read when the trace is.
"""
from __future__ import annotations

import ast
import bisect
import json
import re
from pathlib import Path

CALL_SPAN = "sortbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: host events looked back over for the one running at a time
HOST_LOOKBACK = 256


def _skip_parens(text: str, i: int) -> int:
    """Index just past the parenthesised group that starts at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def global_names(source: str) -> set:
    """The names of the ``__global__`` functions in one CUDA source."""
    names = set()
    for m in re.finditer(r"__global__\b", source):
        i = m.end()
        while True:
            rest = source[i:]
            lb = re.match(r"\s*(?:void\s+)?__launch_bounds__\s*", rest)
            if lb:
                i = _skip_parens(source, i + lb.end())
                continue
            name = re.match(r"\s*(?:void\s+)?([A-Za-z_]\w*)\s*\(", rest)
            if name:
                names.add(name.group(1))
            break
    return names


def _dotted(node) -> str:
    """``triton.jit`` for the expression ``triton.jit`` (or a call of it)."""
    if isinstance(node, ast.Call):
        node = node.func
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def triton_names(source: str) -> set:
    """The names of the functions decorated ``@triton.jit`` (or ``@jit``)
    in one Python source: a Triton kernel runs under its function's
    name."""
    return {node.name for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.FunctionDef)
            and any(_dotted(d) in ("triton.jit", "jit")
                    for d in node.decorator_list)}


def port_kernel_names(package: Path) -> set:
    """Every kernel the package can launch: the ``__global__`` functions of
    its ``.cu`` sources and the ``@triton.jit`` functions of its ``.py``
    sources, anywhere under ``package``."""
    names = set()
    for path in sorted(Path(package).rglob("*.cu")):
        names |= global_names(path.read_text())
    for path in sorted(Path(package).rglob("*.py")):
        names |= triton_names(path.read_text())
    return names


def name_matcher(names):
    """A predicate: does a device event's name (demangled, or mangled with
    a length prefix) name one of ``names``?"""
    if not names:
        return lambda _name: False
    alt = "|".join(sorted((re.escape(n) for n in names), key=len,
                          reverse=True))
    pattern = re.compile(rf"(?<![A-Za-z_])(?:{alt})(?![a-z0-9_])")
    return lambda name: pattern.search(name) is not None


def short_name(name: str, limit: int = 120) -> str:
    """A device op's name without ``void`` and its argument list, at most
    ``limit`` characters."""
    name = re.sub(r"^void\s+", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:limit]


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceTrace:
    """The traced window, read from a Chrome trace's events (times in
    microseconds)."""

    def __init__(self, events: list, port_names):
        is_port = name_matcher(port_names)
        self.calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                            if e.get("cat") == "user_annotation"
                            and e.get("name") == CALL_SPAN)
        if not self.calls:
            raise ValueError("the trace holds no call span")
        self.start, self.end = self.calls[0][0], self.calls[-1][1]
        self.device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a, b = e["ts"], e["ts"] + e["dur"]
            if b <= self.start or a >= self.end:
                continue
            self.device.append({
                "name": e["name"], "cat": e["cat"], "start": a, "end": b,
                "call": self._call_of((a + b) / 2),
                "port": e["cat"] == "kernel" and is_port(e["name"])})
        self.device.sort(key=lambda d: d["start"])
        self.host = sorted(
            (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            for e in events if e.get("cat") in HOST_CATS)
        self._host_starts = [h[0] for h in self.host]

    def _call_of(self, t: float):
        for i, (a, b) in enumerate(self.calls):
            if a <= t <= b:
                return i
        return None

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return _union((max(d["start"], self.start), min(d["end"], self.end))
                      for d in self.device) * 1e-6

    def port_kernel_launches(self) -> int:
        return sum(1 for d in self.device if d["port"])

    def idle_gaps(self):
        """``(start, end)`` of each stretch of the window in which no
        device event runs."""
        gaps, t = [], self.start
        for d in self.device:
            if d["start"] > t:
                gaps.append((t, d["start"]))
            t = max(t, d["end"])
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost host operator running at ``t``: of nested events,
        the latest started that still runs."""
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name in reversed(self.host[max(0, i - HOST_LOOKBACK):i]):
            if b >= t:
                return name
        return "host between operators"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by what
        the host was doing at each gap's middle, seconds, ``top`` each."""
        ops = {}
        for d in self.device:
            key = short_name(d["name"])
            ops[key] = ops.get(key, 0.0) + (d["end"] - d["start"]) * 1e-6
        gaps = {}
        for a, b in self.idle_gaps():
            key = self.host_at((a + b) / 2)
            gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
        rank = lambda m: sorted(m.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(kv) for kv in rank(ops)],
                "idle_gaps": [list(kv) for kv in rank(gaps)]}


def load_chrome_trace(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
