"""The control of ``correct``, and planted faults, on the card.

    python3 sortbench/control.py --workload <name> --seed <n> \\
        --seconds <s> [--fault unchanged|half|altered]

Without ``--fault``: a run of the cell in which the configuration's
reference, with one of its guarantees broken (``control`` of its
reference module), stands in the program's place.  With ``--fault``: the
program with that fault planted under it (``faults.py``).  Either has to
print ``"correct": false``; its compared numbers are the control's
readings.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    bench.setup_paths()
    import torch
    from sortbench import faults, harness
    spec = harness.load_spec(bench.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("sortbench control: needs a CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        entry = harness.load_module("entries", spec.config["entry"])
        call = faults.FAULTS[args.fault](entry.call)
    else:
        call = harness.load_module("references",
                                   spec.config["reference"]).control
    result = harness.run(spec, args.seed, args.seconds, False, "cuda",
                         call=call, t_start=T_START)
    print(json.dumps({"control": args.fault or "reference.control",
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
