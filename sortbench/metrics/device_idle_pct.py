"""``device_idle_pct`` (%): the share of the traced window in which no
kernel, copy or memset ran on the device."""


def read(run):
    tr = run.traced.trace
    if tr.busy_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
