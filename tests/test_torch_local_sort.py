"""The local sort's leaf mode against the reference's finish, byte for byte.

The port's ``segmented_local_sort`` sorts the flagged buckets of the key
buffer in place and moves every value leaf in place with them; the
reference (``repro.kernels.ops``) returns (src, dst) run copies that its
``apply_run_copies`` applies to the keys and the leaves.  Both run on the
same numpy inputs: the reference's bitonic kernel in Pallas interpret mode,
the port's plain version (the CUDA kernel is held to it on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  Every comparison is
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.core import SortConfig as JConfig  # noqa: E402
from repro.core import hybrid_sort as j_sort  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import hybrid_sort  # noqa: E402
from repro_torch.core.interop import config_from_reference  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from conftest import entropy_keys  # noqa: E402

ROW_LEN = 128
#: leaf dtypes of 1, 2, 4 and 8 bytes, mixed
LEAF_SETS = {1: (np.int32,),
             3: (np.int8, np.float64, np.uint16),
             8: (np.int8, np.uint16, np.float32, np.int64, np.bool_,
                 np.float64, np.int32, np.uint8)}


def _t(x):
    """numpy array -> torch tensor; unsigned keys as the port's carrier
    (the signed twin, same bits)."""
    x = np.ascontiguousarray(x)
    if x.dtype.kind == "u" and x.dtype.itemsize > 1:
        x = x.view(np.dtype(f"i{x.dtype.itemsize}"))
    return torch.from_numpy(x.copy())


def _bucket(rng, kind, size, dtype):
    """One bucket's keys: random, or an edge case of the live-bit window."""
    info = np.iinfo(dtype)
    ones = dtype(info.max)
    if kind == "random":
        return rng.integers(0, info.max, size, dtype=dtype, endpoint=True)
    if kind == "ties":
        return rng.integers(0, 4, size, dtype=dtype)
    if kind == "all_equal":
        return np.full(size, ones // dtype(3), dtype)
    if kind == "bit0":                  # differ only in bit 0
        return (ones // dtype(5) & ~dtype(1)) | rng.integers(
            0, 2, size, dtype=dtype)
    if kind == "top_bit":               # differ only in the top bit
        top = dtype(1) << dtype(8 * np.dtype(dtype).itemsize - 1)
        return np.where(rng.random(size) < 0.5, top, dtype(0)) | dtype(6)
    x = rng.integers(0, 30, size, dtype=dtype)          # all-ones keys
    x[rng.random(size) < 0.25] = ones
    return x


def _segments(rng, dtype):
    """Keys of consecutive buckets covering [0, n) with their (start, size,
    flag) tables: every edge kind, sizes 1 and exactly ``ROW_LEN``, and
    unflagged buckets (random keys) between them."""
    kinds = ["random", "ties", "all_equal", "bit0", "top_bit", "ones"] * 2
    sizes = [int(rng.integers(2, ROW_LEN + 1)) for _ in kinds]
    sizes[1], sizes[5], sizes[8] = ROW_LEN, ROW_LEN, 1
    parts, starts, flags, at = [], [], [], 0
    for i, (kind, size) in enumerate(zip(kinds, sizes)):
        if i % 3 == 2:                  # an unflagged bucket first
            gap = int(rng.integers(1, ROW_LEN + 1))
            parts.append(_bucket(rng, "random", gap, dtype))
            starts.append(at)
            flags.append(False)
            at += gap
        parts.append(_bucket(rng, kind, size, dtype))
        starts.append(at)
        flags.append(True)
        at += size
    starts = np.array(starts, np.int32)
    sizes = np.diff(np.append(starts, at)).astype(np.int32)
    return np.concatenate(parts), starts, sizes, np.array(flags)


def _leaves(rng, n, count):
    return [rng.integers(-2**62, 2**62, n).astype(dt)
            for dt in LEAF_SETS[count]]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("count", sorted(LEAF_SETS))
@pytest.mark.parametrize("use_classes", [False, True])
def test_leaf_mode_equals_reference_run_copies(rng, dtype, count,
                                               use_classes):
    x, starts, sizes, flags = _segments(rng, dtype)
    n = x.shape[0]
    leaves = _leaves(rng, n, count)
    classes = (tops.local_sort_class_plan(n, ROW_LEN, s_max=len(starts))
               if use_classes else None)
    with jax.enable_x64(True):
        src, dst = jops.segmented_local_sort(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(sizes),
            jnp.asarray(flags), ROW_LEN, interpret=True, classes=classes)
        want = jops.apply_run_copies(src, dst,
                                     [jnp.asarray(v) for v in [x, *leaves]])
    buf = _t(x)
    got = [_t(v) for v in leaves]
    tops.segmented_local_sort(buf, _t(starts), _t(sizes), _t(flags),
                              ROW_LEN, classes=classes, leaves=got)
    assert buf.numpy().tobytes() == np.asarray(want[0]).tobytes()
    for g, w in zip(got, want[1:]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # unflagged buckets are untouched (the reference's dst == n lanes)
    keep = np.repeat(~flags, sizes)
    assert np.array_equal(buf.numpy().view(dtype)[keep], x[keep])


def test_leaf_mode_and_perm_mode_agree(rng):
    """One call may write positions and move leaves: the leaves are the
    positions' gather, as ``apply_run_copies`` makes it."""
    x, starts, sizes, flags = _segments(rng, np.uint32)
    n = x.shape[0]
    leaves = [_t(v) for v in _leaves(rng, n, 8)]
    before = [v.clone() for v in leaves]
    perm = torch.arange(n, dtype=torch.int32)
    tops.segmented_local_sort(_t(x), _t(starts), _t(sizes), _t(flags),
                              ROW_LEN, perm=perm, leaves=leaves)
    gathered = tops.apply_run_copies(perm.long(), before)
    for g, w in zip(leaves, gathered):
        assert g.numpy().tobytes() == w.numpy().tobytes()


TCFG = JConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)


@pytest.mark.parametrize("dtype,ands", [(np.uint32, 0), (np.uint32, 3),
                                        (np.uint64, 1), (np.uint16, 0)],
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_hybrid_sort_kv_leaves_through_the_finish(rng, dtype, ands):
    """hybrid_sort with eight leaves of mixed widths: the kernel engine's
    finish moves them in place, equal to the reference's run copies."""
    n = 3000
    x = entropy_keys(rng, n, ands, dtype)
    leaves = _leaves(rng, n, 8)
    values = {f"v{i}": v for i, v in enumerate(leaves)}
    with jax.enable_x64(True):
        want = j_sort(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                       values.items()},
                      cfg=TCFG, engine="argsort", return_stats=True)
    pcfg = config_from_reference(dataclasses.asdict(TCFG))
    got = hybrid_sort(x, values, cfg=pcfg, engine="kernel",
                      return_stats=True, device="cpu")
    assert got[-1].used_local_sort
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    for key in values:
        assert got[1][key].numpy().tobytes() == \
            np.asarray(want[1][key]).tobytes(), key
    assert tuple(int(v) for v in got[-1]) == tuple(int(v) for v in want[-1])
