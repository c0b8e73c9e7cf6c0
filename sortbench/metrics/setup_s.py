"""``setup_s`` (s): from the start of the harness's process (once its
interpreter runs ``run.py``) to the first timed call: imports, CUDA's
start, loading (in a checkout's first run, building) the program's
kernels, the inputs and the warm-up calls."""


def read(run):
    return run.setup_s
