"""``sort_roofline`` (%): the device's work on the calls of the traced
window against the least traffic of any sort, ``2 n (key + value bytes)``
a call at the card's HBM peak, over the time in which some device op ran
(the busy union): how close the device's part of a call comes to one read
and one write of every record.  Host gaps are left out: they are
``host_gap_ms``'s."""
from sortbench import roofline


def read(run):
    tr = run.traced.trace
    if tr.busy_s <= 0:
        return None
    moved = roofline.sort_bytes(run.records, run.record_bytes) * tr.n_calls
    return roofline.share_pct(moved, tr.busy_s, run.bandwidth)
