"""Model zoo: config-driven architectures for all assigned families (port
of ``repro.models``)."""
from repro_torch.models.transformer import (DecodeCache, decode_step,
                                            forward, init_cache, init_params,
                                            loss_fn, params_from_reference,
                                            prefill)

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache", "DecodeCache", "params_from_reference"]
