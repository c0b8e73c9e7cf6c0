"""``plan_stream_ms`` (ms): per call of the traced window, how long the
program's plan held the device's stream: the stream time (CUDA events at
each end) of its ``hybrid_sort.plan`` spans, summed, idle time inside them
included.  It is paced by the host under the profiler: the plan's eager ops
enqueue one by one, each at the profiler's per-op cost, so the stream waits
on the host inside the span, and the reading moves with the host as much as
with the plan's device work.  Silent where the program keeps no span
log."""
from sortbench import spanlog


def read(run):
    sorts = spanlog.traced_sorts(run)
    plans = spanlog.named(sorts, "hybrid_sort.plan") if sorts else []
    if not plans:
        return None
    return sum(s["stream_ms"] for s in plans) / len(sorts)
