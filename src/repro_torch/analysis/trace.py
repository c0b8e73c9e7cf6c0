"""The launch recorder: the port's counterpart of the reference's jaxpr walker.

A Pallas kernel body can be read off the traced jaxpr; a CUDA kernel
cannot.  So the port records its launches as they happen.  Every kernel
wrapper tests ``kernels._build.RECORDER`` once, at the place where it has
picked the CUDA kernel or its plain version, and reports the launch:

  * :class:`LaunchRecord` — the port's ``PallasSite``: the kernel's name
    (the reference's Pallas body name, so the ``ANALYSIS_CONTRACT``
    declarations carry over verbatim), the buffers it reads and writes
    (shape, dtype, element size and ``data_ptr()``), the alternate
    buffers it was handed, the descriptor tables' shape, the loop and
    iteration it ran in, and whether the CPU plain version ran;
  * loops — the pass loops open a :class:`Loop` and step it once per
    iteration; a loop counts as its largest per-iteration launch count (the
    traced while body of the reference); an ``unrolled`` loop (the LSD
    passes, the distributed chunk sorts) only labels its launches;
  * collectives — ``LocalMesh``'s all-to-all, all-gather and any report
    their per-shard wire bytes here; a process-group run is counted by
    ``utils.collectives.CollectiveMode``;
  * write replays — with ``hazard=True`` the first fused and merge launch
    of a run is replayed at once with an ``arange`` value leaf, the
    written-exactly-once check of ``refhazard``.

With no recorder the wrappers cost one ``is None`` test per launch.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: the reference's Pallas kernel bodies, by name: the launches a census
#: counts (``merge_rows`` is recorded too, but the reference's R3 pass is
#: plain jnp, not a Pallas kernel)
PALLAS_KERNELS = frozenset({
    "_hist_kernel", "_fused_pass_kernel", "_bitonic_stable_kernel",
    "_kway_merge_kernel", "_multisplit_kernel", "_multisplit_kv_kernel",
    "_assigned_hist_kernel", "_bitonic_kernel", "_bitonic_kv_kernel"})

#: kernels whose launches write a permutation of their input lanes
REPLAYED = frozenset({"_fused_pass_kernel", "_kway_merge_kernel"})


@dataclass(frozen=True)
class Buffer:
    """One tensor a launch reads or writes."""
    shape: Tuple[int, ...]
    dtype: str
    itemsize: int
    ptr: int

    @property
    def numel(self) -> int:
        size = 1
        for d in self.shape:
            size *= d
        return size

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize

    @classmethod
    def of(cls, t: torch.Tensor) -> "Buffer":
        return cls(tuple(int(d) for d in t.shape), str(t.dtype).split(".")[-1],
                   t.element_size(), t.data_ptr())


@dataclass
class LaunchRecord:
    """One kernel launch (or one run of its plain version)."""
    name: str
    plain: bool
    reads: List[Buffer]
    writes: List[Buffer]
    alts: List[Buffer] = field(default_factory=list)
    tables: Optional[Tuple[int, ...]] = None
    loop: Optional[int] = None       # innermost open Recorder.loops entry
    iteration: Optional[int] = None
    in_while: bool = False           # inside a (not unrolled) pass loop
    written_once: Optional[List[str]] = None   # replay findings, if replayed


@dataclass
class Loop:
    """One pass loop of a run: launches per iteration."""
    name: str
    unrolled: bool
    counts: List[int] = field(default_factory=list)
    closed: bool = False

    def step(self) -> None:
        """Begin the next iteration."""
        self.counts.append(0)

    def close(self) -> None:
        self.closed = True

    @property
    def body(self) -> int:
        """The loop's census entry: its largest per-iteration count."""
        return max(self.counts, default=0)


@dataclass
class Collective:
    kind: str             # "all_to_all" | "all_gather" | "psum"
    wire_bytes: float     # per shard


class Recorder:
    """Collects the launches, loops and collectives of one run."""

    def __init__(self, hazard: bool = False):
        self.records: List[LaunchRecord] = []
        self.loops: List[Loop] = []
        self.collectives: List[Collective] = []
        self.hazard = hazard
        self._open: List[int] = []
        self._replayed: set = set()
        self._suspended = 0
        #: kernel launches made while suspended (replays): the profiler
        #: sees them, the census does not
        self.hidden: Dict[str, int] = {}

    # ---- hooks (called by the wrappers) ----------------------------------

    def launch(self, name: str, *, plain: bool, reads=(), writes=(),
               alts=(), tables=None, call=None) -> None:
        """Record one launch.  ``call`` is ``(wrapper, args, kwargs)`` of a
        fused or merge launch, replayed once per run with ``hazard``."""
        if self._suspended:
            if not plain:
                self.hidden[name] = self.hidden.get(name, 0) + 1
            return
        self._open = [i for i in self._open if not self.loops[i].closed]
        whiles = [i for i in self._open if not self.loops[i].unrolled]
        loop = self._open[-1] if self._open else None
        it = None if loop is None else len(self.loops[loop].counts) - 1
        if name in PALLAS_KERNELS and whiles and self.loops[whiles[-1]].counts:
            # a launch counts in the innermost while loop; an unrolled
            # loop only labels it
            self.loops[whiles[-1]].counts[-1] += 1
        rec = LaunchRecord(
            name=name, plain=bool(plain),
            reads=[Buffer.of(t) for t in reads],
            writes=[Buffer.of(t) for t in writes],
            alts=[Buffer.of(t) for t in alts],
            tables=None if tables is None else tuple(int(d) for d in tables),
            loop=loop, iteration=it, in_while=bool(whiles))
        self.records.append(rec)
        if (self.hazard and call is not None and name in REPLAYED and
                name not in self._replayed):
            self._replayed.add(name)
            from repro_torch.analysis import refhazard
            with self.suspended():
                rec.written_once = refhazard.replay_written_once(name, call)

    def loop(self, name: str, unrolled: bool = False) -> Loop:
        """Open a pass loop; the caller steps it per iteration and closes
        it after the last."""
        lp = Loop(name, unrolled)
        self.loops.append(lp)
        self._open.append(len(self.loops) - 1)
        return lp

    def collective(self, kind: str, wire_bytes: float) -> None:
        if not self._suspended:
            self.collectives.append(Collective(kind, float(wire_bytes)))

    @contextlib.contextmanager
    def suspended(self):
        """Launches inside are not recorded (replays, checks)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # ---- reading ---------------------------------------------------------

    def pallas(self) -> List[LaunchRecord]:
        return [r for r in self.records if r.name in PALLAS_KERNELS]

    def while_loops(self) -> List[Loop]:
        return [lp for lp in self.loops if not lp.unrolled]

    def counts(self) -> Dict[str, int]:
        """Launches per kernel name."""
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0) + 1
        return out


@contextlib.contextmanager
def recording(hazard: bool = False):
    """``with recording() as rec:`` — record every launch of the block."""
    if _build.RECORDER is not None:
        raise RuntimeError("a launch recorder is already active")
    rec = Recorder(hazard=hazard)
    _build.RECORDER = rec
    try:
        yield rec
    finally:
        _build.RECORDER = None
