"""Hand-written CUDA kernels (sm_90a) of the hybrid radix sort.

histogram  — the prologue digit histogram (ports ``_hist_kernel``)
fused      — one launch per counting pass: stable partition + scatter of
             pass i fused with the digit histogram of pass i+1 (ports
             ``_fused_pass_kernel``)
bitonic    — the stable shared-memory local sort (ports
             ``_bitonic_stable_kernel``: a per-bucket radix sort on the
             main path, a bitonic network for the (S, L) rows) and the
             library's min/max row network (ports ``_bitonic_kernel``,
             ``_bitonic_kv_kernel``)
ops        — the local-sort finish around it (size classes; value leaves
             moved in place, or a permutation for the gather),
             ``kernel_local_sort``, ``tile_histogram_pass``
merge      — the out-of-core sort's k-way merge-path round (ports
             ``_kway_merge_kernel``) and its partition math
multisplit — per-tile digit-major reorder (ports ``_multisplit_kernel``,
             ``_multisplit_kv_kernel``)
assigned   — the descriptor-driven histogram (ports
             ``_assigned_hist_kernel``)
ref        — the kernels' plain PyTorch versions and the reference's
             oracles (the CPU path, and the ground truth the kernels are
             held to on the card)
_build     — nvcc build at first use, ctypes loading, launch counters,
             the launch recorder's slot (``repro_torch.analysis``)

The package exports the reference's library surface by its names.
``segmented_local_sort`` and ``apply_run_copies`` keep the port's
signatures (an in-place sort that moves value leaves or writes a
permutation, and that permutation's gather; see ``ops``).

The sources live in ``csrc/``.  Each wrapper launches its kernel for CUDA
tensors and runs the plain version for CPU tensors; it never falls back
from one to the other.

Key traffic of a sort with p executed passes over the padded length n_pad
(kb key bytes, vb value bytes): ``(2p + 1)·n_pad·kb + 2p·n_pad·vb`` for the
prologue and the passes, plus ``2·n·(kb + vb)`` for the local sort.  A
merge round (or a spill strip) moves ``2·n_pad·(kb + vb)``: one read and
one write of every key and value.
"""
from repro_torch.kernels._build import COUNTS, reset_counts
from repro_torch.kernels.histogram import radix_histogram
from repro_torch.kernels.multisplit import tile_multisplit, tile_multisplit_kv
from repro_torch.kernels.bitonic import (bitonic_sort_rows,
                                         bitonic_sort_rows_kv,
                                         bitonic_sort_rows_stable)
from repro_torch.kernels.assigned import assigned_histogram
from repro_torch.kernels.fused import (fused_counting_pass, initial_histogram,
                                       make_ping_pong, pad_length)
from repro_torch.kernels.merge import (host_coranks, kway_merge_round,
                                       merge_path_partition, num_merge_rounds,
                                       spill_group_plan)
from repro_torch.kernels.ops import (apply_run_copies, kernel_local_sort,
                                     local_sort_class_plan,
                                     segmented_local_sort, tile_histogram_pass)

__all__ = [
    "COUNTS", "reset_counts",
    "radix_histogram", "tile_multisplit", "tile_multisplit_kv",
    "bitonic_sort_rows", "bitonic_sort_rows_kv", "bitonic_sort_rows_stable",
    "assigned_histogram",
    "fused_counting_pass", "initial_histogram", "make_ping_pong", "pad_length",
    "host_coranks", "kway_merge_round", "merge_path_partition",
    "num_merge_rounds", "spill_group_plan",
    "apply_run_copies", "kernel_local_sort", "local_sort_class_plan",
    "segmented_local_sort", "tile_histogram_pass",
]
