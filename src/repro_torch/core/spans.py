"""Spans of the sort path, kept in memory while a profiler records.

``top(name, device, **attrs)`` opens one whole sort and tests, once,
whether a ``torch.profiler`` (or the autograd profiler) is recording.
While none is, it and every ``span``, ``note`` and ``tally`` inside it do
nothing: a shared no-op context, a few hundred nanoseconds each.  While
one is, each span

* opens ``torch.profiler.record_function(name)``, so that it shows in the
  profiler's trace on the trace's own clock, nested in the caller's spans;
* records a CUDA event on the sort's stream at its start and at its end
  (none for a sort on the CPU).  A span opened right after its previous
  sibling closed starts at that sibling's end event, unless a ``tally``
  enqueued work in between;
* keeps its name, its parent, its host start and end
  (``time.perf_counter_ns``) and its attributes in a ``SpanLog``, which
  holds whole sorts and drops the oldest past ``MAX_SORTS``.

``note`` sets attributes known on the host.  ``tally`` sets one to the sum
of a device tensor: one reduction, enqueued into a buffer of
``COUNT_SLOTS`` int32 that the sort owns, so that the log keeps none of
the sort's tables alive and nothing synchronizes inside a sort.  Stream
times and tallies are read when the log is read (``SpanLog.sorts``),
after the sort's last event has completed; from then on the sort holds
only numbers.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

#: whole sorts a log keeps; the oldest go first
MAX_SORTS = 64
#: tallies one sort may take (a pass each, and the local sort's)
COUNT_SLOTS = 128

_OFF = contextlib.nullcontext()


def _event(stream):
    if stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Tally:
    """An attribute whose value waits in its sort's count buffer."""
    __slots__ = ("slot",)

    def __init__(self, slot: int):
        self.slot = slot


class _Sort:
    """One recorded sort: its spans in the order they opened, and what
    its open spans share."""
    __slots__ = ("spans", "stream", "device", "closed", "counts", "used",
                 "rows")

    def __init__(self, device):
        self.spans = []
        self.device = device
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.closed = None          # the end event of the last closed span
        self.counts = None          # the tallies' buffer, from the first tally
        self.used = 0
        self.rows = None            # the sort as read

    def read(self) -> list:
        if self.rows is None:
            last = self.spans[0].ev1
            if last is not None:
                last.synchronize()
            counts = ([] if self.counts is None else
                      self.counts[:self.used].tolist())
            self.rows = [s.row(counts) for s in self.spans]
            self.spans, self.counts, self.stream = [], None, None
        return self.rows


class _Span:
    """One recording span; the context manager ``span`` returns while its
    sort is recorded."""
    __slots__ = ("log", "sort", "name", "idx", "parent", "attrs", "t0",
                 "t1", "ev0", "ev1", "rf")

    def __init__(self, log, sort, name, attrs):
        self.log, self.sort, self.name, self.attrs = log, sort, name, attrs
        self.t1 = self.ev1 = None

    def __enter__(self):
        stack = self.log._stack()
        sort = self.sort
        self.idx = len(sort.spans)
        self.parent = stack[-1].idx if stack else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = (_event(sort.stream) if sort.closed is None else
                    sort.closed)
        sort.closed = None
        self.t0 = time.perf_counter_ns()
        sort.spans.append(self)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        sort = self.sort
        self.t1 = time.perf_counter_ns()
        self.ev1 = sort.closed = _event(sort.stream)
        self.rf.__exit__(*exc)
        self.rf = None
        log, self.log, self.sort = self.log, None, None
        stack = log._stack()
        stack.pop()
        if not stack:
            log._state.sort = None
            log._sorts.append(sort)
        return False

    def row(self, counts: list) -> dict:
        attrs = {k: counts[v.slot] if isinstance(v, _Tally) else v
                 for k, v in self.attrs.items()}
        return {"name": self.name, "parent": self.parent,
                "start_ns": self.t0, "host_ms": (self.t1 - self.t0) * 1e-6,
                "stream_ms": (None if self.ev0 is None else
                              self.ev0.elapsed_time(self.ev1)),
                "attrs": attrs}


class SpanLog:
    """The spans of whole sorts, at most ``max_sorts`` of them."""

    def __init__(self, max_sorts: int = MAX_SORTS):
        self._sorts = collections.deque(maxlen=max_sorts)
        self._state = threading.local()      # each thread's open spans

    def _stack(self) -> list:
        try:
            return self._state.stack
        except AttributeError:           # this thread's first span
            self._state.stack = []
            self._state.sort = None
            return self._state.stack

    def top(self, name: str, device, **attrs):
        """The span of one whole sort on ``device``: recorded while a
        profiler records; inside an open sort, an inner span."""
        if self._stack():
            return _Span(self, self._state.sort, name, attrs)
        if not torch.autograd._profiler_enabled():
            return _OFF
        self._state.sort = _Sort(torch.device(device))
        return _Span(self, self._state.sort, name, attrs)

    def span(self, name: str, **attrs):
        """A span inside the open sort; a no-op while none is recorded."""
        if not self._stack():
            return _OFF
        return _Span(self, self._state.sort, name, attrs)

    def note(self, **attrs) -> None:
        """Set attributes of the innermost open span, if one records."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def tally(self, key: str, t: torch.Tensor,
              where: torch.Tensor = None) -> None:
        """Set attribute ``key`` of the innermost open span, if one
        records, to the sum of ``t`` (of ``t`` where ``where``)."""
        stack = self._stack()
        if not stack:
            return
        sort = self._state.sort
        if sort.counts is None:
            sort.counts = torch.empty(COUNT_SLOTS, dtype=torch.int32,
                                      device=sort.device)
        if sort.used == COUNT_SLOTS:
            raise RuntimeError(f"a sort took more than {COUNT_SLOTS} "
                               f"tallies")
        if where is not None:
            t = torch.where(where, t, 0)
        torch.sum(t.reshape(-1), 0, dtype=torch.int32,
                  out=sort.counts[sort.used])
        stack[-1].attrs[key] = _Tally(sort.used)
        sort.used += 1
        sort.closed = None          # the next span starts after the sum

    def clear(self) -> None:
        self._sorts.clear()

    def sorts(self) -> list:
        """Each sort kept, oldest first, as its spans in the order they
        opened (the sort's own first): dicts of ``name``, ``parent`` (index,
        None for the sort), ``start_ns`` (host), ``host_ms``, ``stream_ms``
        (None on the CPU) and ``attrs`` (each tally read)."""
        return [sort.read() for sort in list(self._sorts)]


#: the log of the sort path (``core.hybrid``)
LOG = SpanLog()
top, span, note, tally = LOG.top, LOG.span, LOG.note, LOG.tally
