"""``launches_per_sort`` (count): per call of the traced window, the device
ops that ran: kernels, copies and memsets."""


def read(run):
    tr = run.traced.trace
    return len(tr.device) / tr.n_calls if tr.device else None
