"""``read_wait_ms`` (ms): per call of the traced window, how long the host
loop waited on the device: the host time of the program's
``hybrid_sort.read`` spans (each a counted device-to-host read, with the
reductions it reads), summed.  It is read under the profiler, whose
per-op cost lengthens the host's enqueue between reads, so it reads less
than the same wait with no profiler, and it moves with the host.  Silent
where the program keeps no span log."""
from sortbench import spanlog


def read(run):
    sorts = spanlog.traced_sorts(run)
    reads = spanlog.named(sorts, "hybrid_sort.read") if sorts else []
    if not reads:
        return None
    return sum(s["host_ms"] for s in reads) / len(sorts)
