"""repro_torch.optim — the optimizers (updating in place) and block-scaled
int8 gradient compression (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (adamw, adafactor, adamw8bit,
                                          get_optimizer, clip_by_global_norm,
                                          cosine_schedule)
from repro_torch.optim.compression import (compressed_psum, int8_compress,
                                           int8_decompress)

__all__ = ["adamw", "adafactor", "adamw8bit", "get_optimizer",
           "clip_by_global_norm", "cosine_schedule",
           "int8_compress", "int8_decompress", "compressed_psum"]
