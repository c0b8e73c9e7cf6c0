"""``call_p95_ms`` (ms): the 95th percentile of every call's host wall in
the timed window, from the call to the end of its synchronize."""
import statistics


def read(run):
    walls = run.window.walls
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=20, method="inclusive")[18]
