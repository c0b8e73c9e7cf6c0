"""Run one cell of the port's benchmark once and print its result line.

    python3 sortbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``sortbench/``
and the program (``src/repro_torch``).  Needs a CUDA device: without one,
or with fewer than the cell asks for, it exits non-zero and prints no
result.  The last line of standard output is the result (JSON); the last
lines of standard error are the numbers compared, each with its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_paths() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "sortbench" / sub)
    # the harness as the package ``sortbench``, the program from ``src``;
    # not this directory, whose modules would shadow others' names
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_paths()
    import torch
    from sortbench import harness
    spec = harness.load_spec(ROOT, args.workload)
    chips = int(spec.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sortbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
