"""``kernel_device_ms`` (ms): per call of the traced window, the device
time of the program's own CUDA kernels."""


def read(run):
    tr = run.traced.trace
    ms = sum(d["end"] - d["start"] for d in tr.device if d["port"]) * 1e-3
    return ms / tr.n_calls if ms else None
