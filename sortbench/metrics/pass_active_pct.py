"""``pass_active_pct`` (%): of the records the fused passes of the traced
window moved (every record of the call, each pass), the share the
partition needed: the records of each executed pass's active buckets,
summed, over the executed passes times the call's records.  The rest are
done gaps copied through.  Silent where the program keeps no span log."""
from sortbench import spanlog


def read(run):
    sorts = spanlog.traced_sorts(run)
    passes = spanlog.executed_passes(sorts) if sorts else []
    if not passes:
        return None
    return 100.0 * sum(a for a, _ in passes) / sum(n for _, n in passes)
