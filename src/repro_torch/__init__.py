"""repro_torch — the hybrid radix sort ported to PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: the same algorithm,
module for module, with the reference's Pallas kernels rewritten by hand in
CUDA C++ for ``sm_90a`` (``repro_torch.kernels``).  It imports ``torch`` and
never ``jax`` or ``repro``.  Entry points run on the GPU unless the caller
asks for the CPU; on the CPU the kernel engine runs the kernels' plain
PyTorch versions.
"""
from repro_torch.core import (ENGINES, OocStats, SortConfig, SortStats,
                              default_config, hybrid_sort, lsd_sort, oocsort,
                              resolve_engine)

__all__ = ["hybrid_sort", "lsd_sort", "oocsort", "SortConfig", "SortStats",
           "OocStats", "default_config", "ENGINES", "resolve_engine"]
