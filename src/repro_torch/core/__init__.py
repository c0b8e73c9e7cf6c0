"""repro_torch.core — the hybrid MSD radix sort on PyTorch tensors.

Public API (the slices ported so far; ``counting_partition`` and the
merges stay in ``core.segmented``, where the reference keeps them):
  hybrid_sort  — §4: the memory-bandwidth-efficient hybrid radix sort
  lsd_sort     — §3 baseline (CUB analogue, stable LSD passes)
  SortStats    — executed / elided passes, segments at exit
  SortConfig   — tuning knobs (Table 3 defaults)
  oocsort      — §5: the out-of-core pipelined sort (chunk sorts + k-way
                 merge rounds, host spill, faults, checkpoints, resume)
  OocStats     — its transfer / round / fault accounting
  ENGINES, resolve_engine — "argsort" / "scan" / "kernel" and "auto"
"""
from repro_torch.core.bijection import (from_ordered_bits,
                                        from_ordered_bits_np, key_bits,
                                        to_ordered_bits, to_ordered_bits_np)
from repro_torch.core.hybrid import SortStats, hybrid_sort
from repro_torch.core.lsd import lsd_sort
from repro_torch.core.model import (SortConfig, default_config,
                                    expected_speedup, memory_budget,
                                    pass_counts)
from repro_torch.core.outofcore import OocStats, oocsort
from repro_torch.core.ranks import ENGINES, resolve_engine

__all__ = [
    "hybrid_sort", "SortStats", "lsd_sort", "oocsort", "OocStats",
    "SortConfig", "default_config",
    "memory_budget", "pass_counts", "expected_speedup",
    "to_ordered_bits", "from_ordered_bits", "to_ordered_bits_np",
    "from_ordered_bits_np", "key_bits", "ENGINES", "resolve_engine",
]
