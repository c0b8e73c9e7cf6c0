"""``local_sort_roofline`` (%): the local sorts of the traced window
against their roofline: each reads and writes the records of the done
buckets it is handed once, ``2 records (key + value bytes)`` at the card's
HBM peak, summed, over the device time of the local-sort kernels (the
``__global__`` functions of the program's ``csrc/local_sort.cu``).  The
records are the program's own count (its span log); silent where it keeps
none or no call sorted locally."""
from sortbench import devtrace, roofline, spanlog


def read(run):
    sorts = spanlog.traced_sorts(run)
    records = sum(s["attrs"]["records"] for s in
                  spanlog.named(sorts, "hybrid_sort.local_sort")) \
        if sorts else 0
    if not records:
        return None
    is_local = devtrace.name_matcher(devtrace.global_names(
        spanlog.local_sort_source().read_text()))
    seconds = sum(d["end"] - d["start"] for d in run.traced.trace.device
                  if d["port"] and is_local(d["name"])) * 1e-6
    return roofline.share_pct(roofline.sort_bytes(records, run.record_bytes),
                              seconds, run.bandwidth)
