"""``host_gap_ms`` (ms): per call of the traced window, its wall less the
time some device op ran: how long the device waited on the host."""


def read(run):
    tr = run.traced.trace
    if not tr.device:
        return None
    return 1e3 * (tr.window_s - tr.busy_s) / tr.n_calls
