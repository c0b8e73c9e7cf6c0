"""``fused_pass0_roofline`` (%): the first fused counting pass of each call
of the traced window against its roofline.  That pass moves every record
whichever digit it is on: it reads each record once and writes it once,
``2 n (key + value bytes)`` at the card's HBM peak, over its device time.
Silent where no call ran such a pass."""
import re

from sortbench import roofline

PASS = re.compile(r"fused\w*_kernel")


def read(run):
    tr = run.traced.trace
    first = {}
    for d in tr.device:
        if d["port"] and d["call"] is not None and d["call"] not in first \
                and PASS.search(d["name"]):
            first[d["call"]] = (d["end"] - d["start"]) * 1e-6
    if not first:
        return None
    moved = roofline.sort_bytes(run.records, run.record_bytes) * len(first)
    return roofline.share_pct(moved, sum(first.values()), run.bandwidth)
