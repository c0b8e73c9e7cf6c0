"""repro_torch.data — key distributions of the paper's benchmarks (numpy
only, the same arrays as the reference's for the same seed), the
sort-based length bucketing of the data pipeline and the trainer's
restart-exact token stream, ``SyntheticLMData``."""
from repro_torch.data.distributions import (ENTROPY_BITS_32, as_generator,
                                            clustered_keys, constant_keys,
                                            entropy_keys, zipf_keys)
from repro_torch.data.pipeline import (SyntheticLMData,
                                        length_bucketed_batches)

__all__ = ["ENTROPY_BITS_32", "as_generator", "clustered_keys",
           "constant_keys", "entropy_keys", "zipf_keys",
           "length_bucketed_batches", "SyntheticLMData"]
