"""repro_torch.utils — the roofline and the collective counter (port of
``repro.utils``)."""
from repro_torch.utils.collectives import (CollectiveMode, collective_bytes,
                                           collective_counts)
from repro_torch.utils.roofline import (HBM_BW, HBM_CAP, LINK_BW, PEAK_FLOPS,
                                        Roofline, model_flops)

__all__ = ["collective_bytes", "collective_counts", "CollectiveMode",
           "Roofline", "model_flops", "PEAK_FLOPS", "HBM_BW", "LINK_BW",
           "HBM_CAP"]
