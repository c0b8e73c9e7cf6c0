"""Hand-written CUDA kernels (sm_90a) of the hybrid radix sort's hot path.

histogram — the prologue digit histogram (ports ``_hist_kernel``)
fused     — one launch per counting pass: stable partition + scatter of
            pass i fused with the digit histogram of pass i+1 (ports
            ``_fused_pass_kernel``)
bitonic   — the stable shared-memory local sort (ports
            ``_bitonic_stable_kernel``)
ops       — the local-sort finish around it (size classes, value gather)
merge     — the out-of-core sort's k-way merge-path round (ports
            ``_kway_merge_kernel``) and its partition math
ref       — the kernels' plain PyTorch versions (the CPU path, and the
            ground truth the kernels are held to on the card)
_build    — nvcc build at first use, ctypes loading, launch counters

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

__all__ = ["COUNTS", "reset_counts"]
