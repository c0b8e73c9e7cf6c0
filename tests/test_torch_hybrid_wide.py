"""``repro_torch.hybrid_sort`` at digits of 9 to 16 bits against
``repro.core.hybrid_sort``, byte for byte, through ``_check`` of
``tests/test_torch_hybrid.py``.  The d = 16 cases, the slowest (the
plan's (a_max, 65 536) tables on the CPU), are in
``tests/test_torch_hybrid_wide16.py``: ``--dist loadfile`` keeps a file
on one worker, and the split lets two workers share them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import SortConfig as JConfig  # noqa: E402
from test_torch_hybrid import _check  # noqa: E402


def wide_digit_case(rng, d, keys, with_values):
    """Digits of 9 bits (r = 512, the widest of the fused pass's look-back
    kernel; Kimi K2's 384 experts make one such pass), 10 bits (the wide
    variant's narrowest), 12 and 16 bits (the widest SortConfig takes):
    several passes on uniform keys and on AND-3 keys, keys / values / stats
    equal to the reference.  At d = 16 the plan's (a_max, r) tables hold
    n / (∂̂ + 1) * 65536 entries, so n is small and ∂̂ = 1: pairs of keys
    that share a top digit still make a second pass."""
    lt, mt, n = {9: (16, 8, 6000), 16: (1, 1, 1000)}.get(d, (2, 1, 12000))
    cfg = JConfig(d=d, kpb=64, local_threshold=lt, merge_threshold=mt)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    if keys == "and3":
        for _ in range(3):
            x &= rng.integers(0, 2**32, n, dtype=np.uint32)
    stats = _check(x, np.arange(n, dtype=np.int32) if with_values else None,
                   cfg)
    assert stats[0] >= 2                          # executed counting passes


@pytest.mark.parametrize("d", [9, 10, 12])
@pytest.mark.parametrize("keys", ["uniform", "and3"])
@pytest.mark.parametrize("with_values", [False, True])
def test_wide_digit_parity(rng, d, keys, with_values):
    wide_digit_case(rng, d, keys, with_values)
