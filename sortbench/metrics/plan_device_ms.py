"""``plan_device_ms`` (ms): per call of the traced window, the device time
of the kernels, copies and memsets that are not the program's own CUDA
kernels: the eager PyTorch ops of its plan and bookkeeping."""


def read(run):
    tr = run.traced.trace
    if not tr.device:
        return None
    return sum(d["end"] - d["start"] for d in tr.device
               if not d["port"]) * 1e-3 / tr.n_calls
