"""Fault-matrix smoke of the port: one resilient ``repro_torch`` oocsort
run per fault site, green + parity.

For every site in ``repro_torch.core.FAULT_SITES`` it injects two
consecutive transient faults at that site's first op (``fail_at={site:
[0, 1]}``) under the bounded-retry policy and checks that the run stays
green: output byte-identical to the fault-free run, the fault actually
fired, no degradation was needed, the device high-water mark stayed under
the budget, and the link-byte identity ``h2d + d2h == chunk_link +
spill_link + retry_link`` held exactly.  The ``host_corruption``
pseudo-site runs with a checkpoint directory, so the detected corruption
recovers from the round checkpoint instead of raising.

    python scripts/torch_fault_matrix.py --device cpu   # the CPU engine
    python scripts/torch_fault_matrix.py                # the CUDA kernels

On the CPU the sort engine is ``argsort`` and the budget the reference's
4096 bytes.  On the card it is the kernel engine, which pads every chunk
to whole KPB tiles: the runs take the small test config (KPB 64) and an
8192-byte budget, the least that models a chunk sort at KPB 64.

``scripts/torch_ci.sh faults`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (FAULT_SITES, FaultPolicy,  # noqa: E402
                              RetryPolicy, SortConfig, oocsort)

#: the chunk sorts' config on the kernel engine (the tests' small config)
KERNEL_CFG = SortConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)


def site_problems(site, st, got, want, budget) -> list:
    """What went wrong at one site (empty = green)."""
    problems = []
    if not np.array_equal(got[0], want[0]):
        problems.append("keys differ from fault-free run")
    if not np.array_equal(got[1], want[1]):
        problems.append("values differ from fault-free run")
    if site == "host_corruption":
        if st.checksum_failures < 1:
            problems.append("corruption was injected but never detected")
    elif st.faults_injected < 2:
        problems.append(f"expected 2 injected faults, saw "
                        f"{st.faults_injected}")
    if st.degradations:
        problems.append(f"{st.degradations} degradations (retries alone "
                        f"should have absorbed 2 transients)")
    if st.device_high_water_bytes > budget:
        problems.append(f"high water {st.device_high_water_bytes} > "
                        f"budget {budget}")
    if st.h2d_bytes + st.d2h_bytes != (st.chunk_link_bytes +
                                       st.spill_link_bytes +
                                       st.retry_link_bytes):
        problems.append("link-byte identity violated")
    return problems


def run_matrix(n: int = 3000, chunk: int = 700, tile: int = 16,
               budget=None, seed: int = 0, device=None) -> int:
    on_card = device != "cpu"
    cfg = KERNEL_CFG if on_card else None
    if budget is None:
        budget = 8192 if on_card else 4096
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    want_k, want_v, base = oocsort(keys, chunk, values=vals, tile=tile,
                                   spill_budget_bytes=budget, cfg=cfg,
                                   return_stats=True, device=device)
    print(f"baseline: n={n} chunks={base.num_chunks} "
          f"rounds={base.rounds_spilled} hw={base.device_high_water_bytes} "
          f"device={device or 'cuda'}")
    failed = 0
    for site in FAULT_SITES:
        policy = FaultPolicy(seed=seed, fail_at={site: [0, 1]})
        retry = RetryPolicy(max_retries=3)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            kwargs = {}
            if site == "host_corruption":
                # detected corruption recovers from the round checkpoint
                kwargs["checkpoint_dir"] = ckpt_dir
            got_k, got_v, st = oocsort(
                keys, chunk, values=vals, tile=tile, cfg=cfg,
                spill_budget_bytes=budget, faults=policy, retry=retry,
                return_stats=True, device=device, **kwargs)
        problems = site_problems(site, st, (got_k, got_v), (want_k, want_v),
                                 budget)
        status = "ok" if not problems else "FAIL"
        print(f"{site:16s} {status}  faults={st.faults_injected} "
              f"retries={st.retries} checksum_failures={st.checksum_failures} "
              f"retry_link_bytes={st.retry_link_bytes}")
        for p in problems:
            print(f"                 - {p}")
        failed += bool(problems)
    if failed:
        print(f"FAULT MATRIX: {failed}/{len(FAULT_SITES)} sites FAILED")
        return 1
    print(f"FAULT MATRIX: all {len(FAULT_SITES)} sites green")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=700)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--budget", type=int, default=None,
                    help="device-byte budget (default 4096 on the CPU, "
                         "8192 on the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the sort runs (default: the card)")
    args = ap.parse_args(argv)
    return run_matrix(n=args.n, chunk=args.chunk, tile=args.tile,
                      budget=args.budget, seed=args.seed, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
