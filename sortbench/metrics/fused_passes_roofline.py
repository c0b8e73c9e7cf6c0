"""``fused_passes_roofline`` (%): every fused counting pass of the traced
window against what its partition needs: each executed pass reads and
writes the records of its active buckets once, ``2 active (key + value
bytes)`` at the card's HBM peak, summed, over the device time of every
fused-pass kernel (named as ``fused_pass0_roofline`` finds them).  The
done gaps a pass copies through count as time, not as bytes.  The active
records are the program's own count (its span log); silent where it keeps
none."""
import re

from sortbench import roofline, spanlog

PASS = re.compile(r"fused\w*_kernel")


def read(run):
    sorts = spanlog.traced_sorts(run)
    passes = spanlog.executed_passes(sorts) if sorts else []
    seconds = sum(d["end"] - d["start"] for d in run.traced.trace.device
                  if d["port"] and PASS.search(d["name"])) * 1e-6
    if not passes or not seconds:
        return None
    moved = sum(roofline.sort_bytes(a, run.record_bytes) for a, _ in passes)
    return roofline.share_pct(moved, seconds, run.bandwidth)
