"""repro_torch.data — key distributions of the paper's benchmarks (numpy
only, the same arrays as the reference's for the same seed)."""
from repro_torch.data.distributions import (ENTROPY_BITS_32, as_generator,
                                            clustered_keys, constant_keys,
                                            entropy_keys, zipf_keys)

__all__ = ["ENTROPY_BITS_32", "as_generator", "clustered_keys",
           "constant_keys", "entropy_keys", "zipf_keys"]
