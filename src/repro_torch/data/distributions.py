"""Key-distribution generators for the paper's benchmarks (§5–§6): the
port's own copy of ``repro.data.distributions`` (numpy only; the same
arrays for the same seed).

Every generator threads an *explicit* PRNG — an ``np.random.Generator`` or a
plain int seed — and an explicit dtype.  Passing a seed makes a call
replayable in isolation: two benchmark rows built from the same seed get the
same keys no matter what ran in between, where the old shared-``Generator``
style silently coupled every row to the consumption order of its
predecessors (and tempted call sites into the global ``np.random`` state).
``as_generator`` is the one conversion point; ``None`` is rejected on
purpose — an OS-entropy default would un-fix exactly that.

``entropy_keys`` implements the Thearling & Smith entropy-reduction
benchmark: repeatedly AND uniform draws; for 32-bit keys 0..3 ANDs give
entropies of 32.00, 25.95, 17.41, 10.78 bits (the paper's x-axis).
``zipf_keys`` matches the PARADIS comparison (§6.2) and ``clustered_keys``
the skewed near-sorted inputs the §5 out-of-core pipeline is benchmarked
against (heavy duplication inside narrow key ranges — the distribution that
stresses merge-path tie handling).
"""
from __future__ import annotations

import numpy as np


ENTROPY_BITS_32 = {0: 32.0, 1: 25.95, 2: 17.41, 3: 10.78, 4: 6.42, 5: 3.68,
                   6: 2.07, 7: 1.15, 8: 0.63, 9: 0.34, 10: 0.18}


def as_generator(rng) -> np.random.Generator:
    """Explicit PRNG threading: an int seed or a ``Generator`` — never the
    global ``np.random`` state, never OS entropy."""
    if isinstance(rng, np.random.Generator):
        return rng
    if isinstance(rng, (int, np.integer, np.random.SeedSequence)):
        return np.random.default_rng(rng)
    raise TypeError(
        f"pass an int seed or np.random.Generator, got {type(rng).__name__}; "
        "implicit/global PRNG state is not supported")


def entropy_keys(rng, n: int, ands: int, dtype=np.uint32) -> np.ndarray:
    rng = as_generator(rng)
    info = np.iinfo(dtype)
    x = rng.integers(0, info.max, n, dtype=dtype, endpoint=True)
    for _ in range(ands):
        x &= rng.integers(0, info.max, n, dtype=dtype, endpoint=True)
    return x


def constant_keys(n: int, value: int = 0, dtype=np.uint32) -> np.ndarray:
    return np.full(n, value, dtype=dtype)


def zipf_keys(rng, n: int, a: float = 1.2, dtype=np.uint32) -> np.ndarray:
    rng = as_generator(rng)
    x = rng.zipf(a, n)                       # int64 samples
    cap = min(np.iinfo(dtype).max, np.iinfo(x.dtype).max)
    return np.minimum(x, cap).astype(dtype)


def clustered_keys(rng, n: int, clusters: int = 64, spread: int = 1 << 16,
                   dtype=np.uint32) -> np.ndarray:
    """Keys piled around a few uniform cluster centres (§5's skewed input).

    Each key is a uniformly chosen centre plus a uniform offset in
    ``[0, spread)`` — massive duplication of high digits inside narrow
    ranges, the case where MSD passes finish early and the out-of-core merge
    sees long equal-key ties across runs.
    """
    rng = as_generator(rng)
    info = np.iinfo(dtype)
    centers = rng.integers(0, info.max, clusters, dtype=dtype, endpoint=True)
    idx = rng.integers(0, clusters, n)
    # unsigned arithmetic end to end: uint64 + int64 would promote to
    # float64 and round 64-bit keys to 53-bit mantissas
    off = rng.integers(0, max(1, spread), n, dtype=np.uint64)
    return (centers[idx].astype(np.uint64) + off).astype(dtype)
