"""Checks of the sort engines' kernel contracts on recorded runs: the port
of ``repro.analysis``.

The reference reads every property off the traced jaxpr.  A CUDA kernel
cannot be traced that way, so the port runs each entry point once, at the
reference's shapes on random inputs from a seed, with every launch
recorded, and checks the run against the same declarations:

  ``trace``      the launch recorder (kernel, buffers, tables, loop)
  ``expr``       restricted evaluator for the declared symbolic formulas
  ``census``     launch census (one launch per counting pass), and on the
                 card the recorder against ``torch.profiler``
  ``donation``   in-place audit (alternates written and returned, no
                 silent ping-pong copies)
  ``transfer``   sweep bytes from the recorded buffers; collective wire
                 bytes against the link table
  ``refhazard``  descriptor-table intervals; every lane written once
  ``lint``       AST rules (no sort in the kernels, no global PRNG in
                 the data layer, no twin of an alternate buffer)
  ``contracts``  the registry binding declarations to run recipes

``python -m repro_torch.analysis`` runs the whole sweep (see ``__main__``).
"""
from repro_torch.analysis.contracts import (CONTRACTS, REGISTRY, TCFG,
                                            Contract, ContractReport,
                                            dist_params, expected_census,
                                            hybrid_params, lsd_params,
                                            merge_params, run_all,
                                            run_contract, spp_params,
                                            table_checks)
from repro_torch.analysis.lint import LintFinding, lint_source, run_lint
from repro_torch.analysis.trace import Recorder, recording

__all__ = [
    "CONTRACTS", "REGISTRY", "TCFG", "Contract", "ContractReport",
    "dist_params", "expected_census", "hybrid_params", "lsd_params",
    "merge_params", "spp_params",
    "run_all", "run_contract", "table_checks",
    "LintFinding", "lint_source", "run_lint",
    "Recorder", "recording",
]
