"""Roofline math for the NVIDIA H100 SXM target (port of
``repro.utils.roofline``, with the H100's constants in place of the
reference's target).

Per GPU:

* ``PEAK_FLOPS`` 989 TFLOP/s: bf16 dense on the tensor cores (NVIDIA H100
  Tensor Core GPU data sheet, SXM);
* ``HBM_BW`` 3.35 TB/s: HBM3 (the same data sheet; the rate
  ``chip_smoke.py`` holds every kernel to);
* ``HBM_CAP`` 80 GB (the same data sheet);
* ``LINK_BW`` 50 GB/s: one 400 Gb/s NDR InfiniBand port per GPU (NVIDIA
  DGX H100 system guide: eight ConnectX-7 ports for eight GPUs).  The
  production mesh's 16-wide axes span more than one 8-GPU node, so a
  collective over them is as slow as its inter-node hop; NVLink's 450 GB/s
  each way reaches only the GPUs of one node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per GPU (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s per GPU (H100 SXM data sheet)
LINK_BW = 50e9               # bytes/s per GPU: one 400 Gb/s NDR port (DGX H100)
HBM_CAP = 80e9               # bytes per GPU (H100 SXM data sheet)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    step: str
    mesh: str
    chips: int
    flops_per_chip: float          # the FLOPs of one chip's local ops
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops_global: float      # 6*N*D (active params for MoE)
    mem_per_chip: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: overlapped execution => max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/dispatch/padding waste
        detector."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU: useful FLOPs over peak during t_bound."""
        denom = self.t_bound * PEAK_FLOPS * self.chips
        return self.model_flops_global / denom if denom else 0.0

    @property
    def fits(self) -> bool:
        return self.mem_per_chip <= HBM_CAP

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "step": self.step,
            "mesh": self.mesh, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_global,
            "counted_flops_per_chip": self.flops_per_chip,
            "useful_flops_frac": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "mem_per_chip_gib": self.mem_per_chip / 1024**3,
            "fits_80gb": self.fits,
        }


def model_flops(cfg, shape_cfg) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode D = one token per sequence."""
    n = cfg.active_param_count()
    if shape_cfg.kind == "train":
        return 6.0 * n * shape_cfg.tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n * shape_cfg.tokens          # forward only
    return 2.0 * n * shape_cfg.global_batch        # decode: 1 new token/seq
