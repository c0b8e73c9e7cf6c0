"""The library-surface kernels' plain versions against the JAX kernels.

Row sorts (``bitonic_sort_rows``, ``bitonic_sort_rows_kv``), the tile
multisplit, the descriptor-driven histogram and the ``ops`` compositions
around them: the reference runs in Pallas interpret mode on the same numpy
inputs, the port's wrappers run their plain versions on CPU tensors, and
every comparison is of the output bytes.  The CUDA kernels are held to the
same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.assigned import assigned_histogram as j_assigned  # noqa
from repro.kernels.bitonic import bitonic_sort_rows as j_rows  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_rows_kv as j_rows_kv  # noqa
from repro.kernels.multisplit import tile_multisplit as j_split  # noqa
from repro.kernels.multisplit import tile_multisplit_kv as j_split_kv  # noqa
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from conftest import entropy_keys  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _t(x):
    """numpy array -> CPU tensor of the same dtype (bf16 through its bits)."""
    x = np.ascontiguousarray(x)
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bytes(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.element_size() == w.dtype.itemsize
        assert _bytes(g) == w.tobytes()


def _x64(dtype):
    """The reference keeps 64-bit keys only under jax.enable_x64."""
    return jax.enable_x64(np.dtype(dtype).itemsize == 8)


def _row_keys(rng, shape, dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f" or dtype == BF16:
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True, dtype=dtype)


def _special_floats(rng, shape, dtype):
    """Normal values mixed with random bit patterns (NaNs of every payload
    and sign, subnormals, infinities), +0 and -0."""
    x = rng.standard_normal(shape).astype(dtype)
    u = _UINT[np.dtype(dtype).itemsize]
    bits = x.view(u)
    m = rng.random(shape)
    noise = rng.integers(0, 2**63, shape, dtype=np.uint64).astype(u)
    bits[m < 0.15] = noise[m < 0.15]
    bits[(m >= 0.15) & (m < 0.25)] = 0
    bits[(m >= 0.25) & (m < 0.35)] = u(1) << u(8 * np.dtype(u).itemsize - 1)
    return x


# ------------------------------ row network -------------------------------

ROW_DTYPES = [np.uint32, np.int32, np.float32, np.int64, np.float64,
              np.uint16, BF16, np.float16]


@pytest.mark.parametrize("s,l", [(1, 64), (5, 128), (3, 1024)])
@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=lambda d: np.dtype(d).name)
def test_rows_plain_equals_kernel(rng, s, l, dtype):
    keys = _row_keys(rng, (s, l), dtype)
    with _x64(dtype):
        want = j_rows(jnp.asarray(keys), interpret=True)
    got = tk.bitonic_sort_rows(_t(keys))
    assert got.dtype == _t(keys).dtype
    _same(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint64,
                                   np.bool_], ids=lambda d: np.dtype(d).name)
def test_rows_plain_other_integer_dtypes(rng, dtype):
    keys = (rng.integers(0, 2, (4, 32)).astype(bool) if dtype is np.bool_
            else _row_keys(rng, (4, 32), dtype))
    vals = np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
    with _x64(dtype):
        want = j_rows(jnp.asarray(keys), interpret=True)
        want_kv = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals),
                            interpret=True)
    _same(tk.bitonic_sort_rows(_t(keys)), want)
    _same(tk.bitonic_sort_rows_kv(_t(keys), _t(vals)), want_kv)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, BF16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("l", [2, 16, 256])
def test_rows_plain_special_floats(rng, dtype, l):
    """NaN payloads and signs, subnormals, ±0 and ±inf: the network's XLA
    min/max (NaN propagates, -0 below +0, subnormals flushed except f16,
    bf16 NaNs made quiet) and the move mask (NaN != NaN, -0 == +0)."""
    keys = _special_floats(rng, (6, l), dtype)
    vals = np.arange(6 * l, dtype=np.int32).reshape(6, l)
    with _x64(dtype):
        want = j_rows(jnp.asarray(keys), interpret=True)
        want_kv = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals),
                            interpret=True)
    _same(tk.bitonic_sort_rows(_t(keys)), want)
    _same(tk.bitonic_sort_rows_kv(_t(keys), _t(vals)), want_kv)


def test_rows_kv_plain_duplicates(rng):
    keys = rng.integers(0, 1000, (4, 256)).astype(np.uint32)
    vals = np.arange(4 * 256, dtype=np.int32).reshape(4, 256)
    want = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    got = tk.bitonic_sort_rows_kv(_t(keys), _t(vals))
    _same(got, want)
    ks, vs = (g.numpy() for g in got)
    for i in range(4):                   # pair consistency, not stability
        assert np.array_equal(keys[i][vs[i] - i * 256], ks[i])


def test_rows_kv_plain_signed_zeros_keep_their_values():
    """-0 == +0: the keys' sign bits reorder while no value moves."""
    keys = np.array([[0.0, -0.0, 0.0, -0.0]], np.float32)
    vals = np.arange(4, dtype=np.int32)[None]
    want = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    got_k, got_v = tk.bitonic_sort_rows_kv(_t(keys), _t(vals))
    _same((got_k, got_v), want)
    assert got_k.view(torch.int32).tolist() == [[-2**31, -2**31, 0, 0]]
    assert got_v.tolist() == [[0, 1, 2, 3]]


def test_rows_kv_plain_nan_row():
    """One NaN turns the whole row into that NaN; every NaN lane takes its
    partner's value at every step (NaN != NaN)."""
    nan = np.array([0x7F800001], np.uint32).view(np.float32)[0]
    keys = np.array([[3.0, 1.0, nan, 2.0, -1.0, 5.0, 0.5, -7.0]], np.float32)
    vals = np.arange(8, dtype=np.int32)[None]
    want = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals), interpret=True)
    got_k, got_v = tk.bitonic_sort_rows_kv(_t(keys), _t(vals))
    _same((got_k, got_v), want)
    assert got_k.view(torch.int32).tolist() == [[0x7F800001] * 8]
    _same(tk.bitonic_sort_rows(_t(keys)), j_rows(jnp.asarray(keys),
                                                 interpret=True))


@pytest.mark.parametrize("vdtype", [np.int8, np.uint16, np.float32,
                                    np.int64],
                         ids=lambda d: np.dtype(d).name)
def test_rows_kv_plain_value_dtypes(rng, vdtype):
    keys = rng.integers(0, 50, (3, 64)).astype(np.int32)
    vals = _row_keys(rng, (3, 64), vdtype)
    with _x64(vdtype):
        want = j_rows_kv(jnp.asarray(keys), jnp.asarray(vals),
                         interpret=True)
    _same(tk.bitonic_sort_rows_kv(_t(keys), _t(vals)), want)


def test_rows_single_lane_rows_are_copied():
    keys = np.array([[3], [1]], np.int32)
    _same(tk.bitonic_sort_rows(_t(keys)), j_rows(jnp.asarray(keys),
                                                 interpret=True))


def test_rows_reject_what_the_network_cannot_take():
    with pytest.raises(ValueError, match="power of two"):
        tk.bitonic_sort_rows(torch.zeros((2, 12), dtype=torch.int32))
    with pytest.raises(TypeError, match="does not take"):
        tk.bitonic_sort_rows(torch.zeros((2, 8), dtype=torch.complex64))


def test_kernel_local_sort_plain_equals_reference(rng):
    keys = rng.integers(0, 2**32, (6, 128), dtype=np.uint32)
    keys[:, 100:] = 0xFFFFFFFF                     # sentinel-padded buckets
    want = jops.kernel_local_sort(jnp.asarray(keys), interpret=True)
    _same(tk.kernel_local_sort(_t(keys)), want)


# ------------------------------- multisplit -------------------------------

@pytest.mark.parametrize("t,kpb", [(1, 128), (3, 256), (2, 512)])
@pytest.mark.parametrize("shift,width", [(24, 8), (0, 8), (16, 6)])
def test_multisplit_plain_equals_kernel(rng, t, kpb, shift, width):
    keys = rng.integers(0, 2**32, (t, kpb), dtype=np.uint32)
    want = j_split(jnp.asarray(keys), shift, width, 32, interpret=True)
    got = tk.tile_multisplit(_t(keys), shift, width, 32)
    assert got[0].dtype == torch.uint32
    _same(got, want)


def test_multisplit_plain_skewed(rng):
    x = entropy_keys(rng, 512, 8).reshape(2, 256)
    want = j_split(jnp.asarray(x), 24, 8, 32, interpret=True)
    _same(tk.tile_multisplit(_t(x), 24, 8, 32), want)


@pytest.mark.parametrize("key_bits", [1, 16, 17, 32, 48])
def test_multisplit_plain_key_bits_truncate(rng, key_bits):
    """The reference rebuilds keys from ceil(key_bits / 16) 16-bit halves:
    key_bits = 16 drops the high half of uint32 keys."""
    keys = rng.integers(0, 2**32, (2, 128), dtype=np.uint32)
    want = j_split(jnp.asarray(keys), 0, 4, key_bits, interpret=True)
    got = tk.tile_multisplit(_t(keys), 0, 4, key_bits)
    _same(got, want)
    if key_bits <= 16:
        assert int(got[0].view(torch.int32).max()) < 1 << 16


@pytest.mark.parametrize("dtype", [np.int32, np.uint16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shift,width", [(28, 8), (12, 8), (40, 4), (0, 1)])
def test_multisplit_plain_dtype_own_shift(rng, dtype, shift, width):
    """Signed keys shift arithmetically, unsigned ones logically; a shift
    past the top bit gives the sign fill or 0."""
    keys = _row_keys(rng, (2, 128), dtype)
    want = j_split(jnp.asarray(keys), shift, width, 32, interpret=True)
    _same(tk.tile_multisplit(_t(keys), shift, width, 32), want)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64],
                         ids=lambda d: np.dtype(d).name)
def test_multisplit_plain_64bit(rng, dtype):
    keys = _row_keys(rng, (2, 256), dtype)
    vals = rng.integers(-2**62, 2**62, (2, 256), dtype=np.int64)
    with jax.enable_x64(True):
        want = j_split(jnp.asarray(keys), 56, 8, 64, interpret=True)
        want_kv = j_split_kv(jnp.asarray(keys), jnp.asarray(vals), 40, 8, 64,
                             48, interpret=True)
    _same(tk.tile_multisplit(_t(keys), 56, 8, 64), want)
    _same(tk.tile_multisplit_kv(_t(keys), _t(vals), 40, 8, 64, 48), want_kv)


@pytest.mark.parametrize("vdtype,val_bits", [(np.int32, 32), (np.int32, 16),
                                             (np.uint16, 16),
                                             (np.uint32, 20)])
def test_multisplit_kv_plain_equals_kernel(rng, vdtype, val_bits):
    keys = rng.integers(0, 2**32, (3, 256), dtype=np.uint32)
    vals = _row_keys(rng, (3, 256), vdtype)
    want = j_split_kv(jnp.asarray(keys), jnp.asarray(vals), 16, 6, 32,
                      val_bits, interpret=True)
    got = tk.tile_multisplit_kv(_t(keys), _t(vals), 16, 6, 32, val_bits)
    assert got[1].dtype == _t(vals).dtype
    _same(got, want)


@pytest.mark.parametrize("width", [9, 12, 16])
@pytest.mark.parametrize("dtype", [np.uint32, np.int64],
                         ids=lambda d: np.dtype(d).name)
def test_multisplit_wide_digits_plain_equals_kernel(rng, width, dtype):
    """Digits of 9 to 16 bits (the CUDA kernel's two 8-bit rounds), keys
    alone and with values, at KPB 128; 64-bit keys shift arithmetically."""
    keys = _row_keys(rng, (3, 128), dtype)
    keys[1] = keys[1, 0]                        # one all-equal tile
    vals = rng.integers(-2**31, 2**31, (3, 128)).astype(np.int32)
    bits = 8 * np.dtype(dtype).itemsize
    shift = bits - width - 3
    with jax.enable_x64(True):
        want = j_split(jnp.asarray(keys), shift, width, bits, interpret=True)
        want_kv = j_split_kv(jnp.asarray(keys), jnp.asarray(vals), shift,
                             width, bits, 32, interpret=True)
    _same(tk.tile_multisplit(_t(keys), shift, width, bits), want)
    _same(tk.tile_multisplit_kv(_t(keys), _t(vals), shift, width, bits, 32),
          want_kv)


def test_multisplit_rejects_what_the_reference_rejects():
    with pytest.raises(TypeError, match="multisplit takes"):
        tk.tile_multisplit(torch.zeros((1, 8), dtype=torch.int16), 0, 4, 16)
    with pytest.raises(ValueError, match=">= 1"):
        tk.tile_multisplit(torch.zeros((1, 8), dtype=torch.int32), 0, 4, 0)


# ------------------------------ histograms --------------------------------

@pytest.mark.parametrize("shift,width", [(24, 8), (0, 4), (28, 8)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_assigned_histogram_plain_equals_kernel(rng, shift, width, dtype):
    """Out-of-order tiles, indices past either end (the reference counts
    [-T, -1] from the end, then clamps), valid 0, 2 and -3 (a multiplier)."""
    keys = _row_keys(rng, (6, 256), dtype)
    tile_idx = np.array([3, 0, 5, 1, 4, 0, 7, -1, -6, -9, 2**31 - 1, -2**31,
                         2], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1, 2, 1, -3, 0], np.int32)
    want = j_assigned(jnp.asarray(keys), jnp.asarray(tile_idx),
                      jnp.asarray(valid), shift, width, interpret=True)
    got = tk.assigned_histogram(_t(keys), _t(tile_idx), _t(valid), shift,
                                width)
    _same(got, want)
    hist = tref.radix_histogram_ref(_t(keys), shift, width)
    assert torch.equal(got[7], hist[5]) and torch.equal(got[9], 2 * hist[0])
    assert not got[5].any()


@pytest.mark.parametrize("width", [9, 12, 16])
def test_assigned_histogram_wide_digits_plain_equals_kernel(rng, width):
    """Digits of 9 to 16 bits (the CUDA kernel's shared (r,) table, and
    past 14 bits its global atomics adding valid[g] per key): out-of-order
    and clamped tiles, valid 0, 2 and -3."""
    keys = _row_keys(rng, (4, 128), np.uint32)
    keys[2] = keys[2, 5]                        # one all-equal tile
    tile_idx = np.array([3, 0, 2, 1, -1, 9, 2], np.int32)
    valid = np.array([1, 2, 1, 0, 1, -3, 1], np.int32)
    want = j_assigned(jnp.asarray(keys), jnp.asarray(tile_idx),
                      jnp.asarray(valid), 32 - width, width, interpret=True)
    _same(tk.assigned_histogram(_t(keys), _t(tile_idx), _t(valid),
                                32 - width, width), want)


def test_tile_histogram_pass_doctest_example():
    x = np.array([0x01020304, 0xFF000000], np.uint32)
    hist, total = tk.tile_histogram_pass(_t(x), shift=24, width=8, kpb=8)
    assert (int(total[0x01]), int(total[0xFF]), int(total.sum())) == (1, 1, 2)
    _same((hist, total), jops.tile_histogram_pass(jnp.asarray(x), 24, 8,
                                                  kpb=8))


@pytest.mark.parametrize("n,kpb,shift,width", [(5000, 1024, 24, 8),
                                               (4096, 512, 0, 8),
                                               (777, 64, 28, 8),
                                               (128, 64, 0, 4)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32],
                         ids=lambda d: np.dtype(d).name)
def test_tile_histogram_pass_plain_equals_reference(rng, n, kpb, shift, width,
                                                    dtype):
    """Sentinel padding comes off digit r - 1 of the total, also where the
    sentinel's digit is another (the reference's rule, kept)."""
    x = _row_keys(rng, (n,), dtype)
    want = jops.tile_histogram_pass(jnp.asarray(x), shift, width, kpb=kpb)
    _same(tk.tile_histogram_pass(_t(x), shift, width, kpb=kpb), want)


def test_radix_histogram_takes_unsigned_keys(rng):
    """The reference's entry point on its own dtypes: uint32 keys shift
    logically (shift + width past the top bit), int32 ones arithmetically."""
    x = rng.integers(0, 2**32, (3, 256), dtype=np.uint32)
    from repro.kernels.histogram import radix_histogram as j_hist
    for keys in (x, x.view(np.int32)):
        want = j_hist(jnp.asarray(keys), 28, 8, interpret=True)
        _same(tk.radix_histogram(_t(keys), 28, 8), want)


# ------------------------- the oracles, ported ----------------------------

@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint16],
                         ids=lambda d: np.dtype(d).name)
def test_tile_multisplit_oracle_equals_reference(rng, dtype):
    keys = _row_keys(rng, (3, 256), dtype)
    want = jref.tile_multisplit_ref(jnp.asarray(keys), 12, 8)
    _same(tref.tile_multisplit_ref(_t(keys), 12, 8), want)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.float16, BF16],
                         ids=lambda d: np.dtype(d).name)
def test_bitonic_sort_rows_oracle_equals_reference(rng, dtype):
    """jnp.sort's comparator: NaNs last, -0 == +0, subnormals of f32 and
    bf16 equal to zero on the CPU; values by a stable argsort."""
    keys = (_special_floats(rng, (4, 64), dtype)
            if np.dtype(dtype).kind == "f" or np.dtype(dtype) == BF16
            else rng.integers(0, 40, (4, 64)).astype(dtype))
    vals = np.arange(4 * 64, dtype=np.int32).reshape(4, 64)
    _same(tref.bitonic_sort_rows_ref(_t(keys)),
          jref.bitonic_sort_rows_ref(jnp.asarray(keys)))
    _same(tref.bitonic_sort_rows_ref(_t(keys), _t(vals)),
          jref.bitonic_sort_rows_ref(jnp.asarray(keys), jnp.asarray(vals)))


def test_bitonic_sort_rows_oracle_bf16_nan_payloads():
    """The reference sorts bf16 rows as float32 on the CPU: each NaN comes
    back as the quiet NaN of its sign, whatever its payload."""
    bits = np.array([[0x7FC1, 0x3F80, 0xFFAC, 0x0001, 0x7F81, 0xFF80,
                      0x8000, 0x7FFF]], np.uint16)
    keys = bits.view(BF16)
    vals = np.arange(8, dtype=np.int32)[None]
    want = jref.bitonic_sort_rows_ref(jnp.asarray(keys), jnp.asarray(vals))
    _same(tref.bitonic_sort_rows_ref(_t(keys), _t(vals)), want)
    assert sorted(np.asarray(want[0]).view(np.uint16)[0, -4:].tolist()) == \
        [0x7FC0, 0x7FC0, 0x7FC0, 0xFFC0]


def test_onehot_matmul_hist_oracle_equals_reference(rng):
    keys = rng.integers(0, 2**32, (4, 512), dtype=np.uint32)
    for shift, width in ((24, 8), (29, 8), (3, 5)):
        _same(tref.onehot_matmul_hist_ref(_t(keys), shift, width),
              jref.onehot_matmul_hist_ref(jnp.asarray(keys), shift, width))


def test_library_surface_names_match_the_reference():
    import repro.kernels as jk
    missing = [n for n in jk.__all__ if n not in tk.__all__]
    assert not missing, missing
