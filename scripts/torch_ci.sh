#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port (src/repro_torch), on a CPU host:
#
#   scripts/torch_ci.sh fast    — the port's CPU tests, tests/test_torch_*.py
#                                 (each module held to the reference on the
#                                 same inputs; tests/test_torch_gpu.py skips
#                                 without a card)
#   scripts/torch_ci.sh analyze — the contract layer on the kernels' plain
#                                 versions: python -m repro_torch.analysis
#                                 --device cpu (census, sort-free, in-place,
#                                 sweep and link bytes, table hazards, lint;
#                                 writes ANALYSIS_report.json)
#   scripts/torch_ci.sh faults  — the fault matrix: one resilient oocsort
#                                 per fault site (scripts/torch_fault_matrix.py)
#   scripts/torch_ci.sh [full]  — all three back to back
#
# On a GPU machine the same checks run on the card with
# `python -m repro_torch.analysis`, `python scripts/torch_fault_matrix.py`
# and `python -m pytest -m gpu tests/test_torch_gpu.py`.  Extra args after
# the stage name pass through to pytest.
set -euo pipefail
cd "$(dirname "$0")/.."

STAGE="${1:-full}"
if [[ "$STAGE" == "fast" || "$STAGE" == "analyze" || "$STAGE" == "faults" \
      || "$STAGE" == "full" ]]; then
  if [[ $# -gt 0 ]]; then shift; fi
else
  STAGE="full"
fi

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

if [[ "$STAGE" == "fast" || "$STAGE" == "full" ]]; then
  echo "=== the port's CPU tests ==="
  python -m pytest -q tests/test_torch_*.py "$@"
fi
if [[ "$STAGE" == "analyze" || "$STAGE" == "full" ]]; then
  echo "=== the contract layer on the plain versions ==="
  python -m repro_torch.analysis --device cpu --json ANALYSIS_report.json
fi
if [[ "$STAGE" == "faults" || "$STAGE" == "full" ]]; then
  echo "=== the fault matrix on the plain versions ==="
  python scripts/torch_fault_matrix.py --device cpu
fi
