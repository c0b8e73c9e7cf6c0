"""The command line: ``python -m repro_torch.analysis [--json PATH] [--only NAME]
[--device cpu|cuda]``.

Runs every registered contract (census, sort-free, in-place, transfer,
link, hazard) on a recorded run, the descriptor-table checks, and the
source lint; prints one PASS/FAIL line per contract and for lint, and exits
non-zero on any finding.  The runs go to the card by default (the CUDA
kernels); ``--device cpu`` runs the kernels' plain versions instead.
Without a GPU and without ``--device cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="verify the declared kernel contracts on recorded runs")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write a machine-readable report to PATH")
    ap.add_argument("--only", metavar="NAME", default=None,
                    help="run a single contract by registry name")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runs go (default: the card)")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("analysis: no CUDA device is available; pass --device cpu to "
              "check the plain versions", file=sys.stderr)
        return 2

    from repro_torch.analysis import contracts, lint

    t0 = time.time()
    if args.only:
        if args.only not in contracts.REGISTRY:
            ap.error(f"unknown contract {args.only!r}; have "
                     f"{sorted(contracts.REGISTRY)}")
        reports = [contracts.run_contract(contracts.REGISTRY[args.only],
                                          args.device)]
    else:
        reports = contracts.run_all(args.device)

    src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lint_findings = lint.run_lint(src_root)

    failures = 0
    for rep in reports:
        nchecks = len(rep.checks)
        if rep.ok:
            print(f"  PASS {rep.name} ({nchecks} checks)")
        else:
            failures += len(rep.findings)
            print(f"  FAIL {rep.name}")
            for f in rep.findings:
                print(f"       {f}")
    if lint_findings:
        failures += len(lint_findings)
        print("  FAIL lint")
        for f in lint_findings:
            print(f"       {f}")
    else:
        print(f"  PASS lint ({len(lint._RULES)} rules)")

    dt = time.time() - t0
    verdict = "GREEN" if failures == 0 else f"{failures} finding(s)"
    print(f"analysis: {len(reports)} contracts + lint on {args.device} in "
          f"{dt:.1f}s — {verdict}")

    if args.json:
        payload = {
            "ok": failures == 0,
            "device": args.device,
            "seconds": round(dt, 2),
            "contracts": [rep.to_dict() for rep in reports],
            "lint": [vars(f) for f in lint_findings],
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
        print(f"report written to {args.json}")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
