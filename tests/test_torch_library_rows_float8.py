"""The row network's plain versions on float8 and 4-bit keys against the
JAX kernels (split from ``tests/test_torch_library_kernels.py``, whose
helpers it uses, so that ``--dist loadfile`` runs the two files on two
workers).

Every float8 format and int4 / uint4: random rows mixed with each
format's special encodings, all 65 536 ordered pairs of encodings, and the
bytes the probes of XLA's CPU min/max found, pinned; the reference runs in
Pallas interpret mode on the same bytes.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_rows as j_rows  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_rows_kv as j_rows_kv  # noqa
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_library_kernels import _same, _t  # noqa: E402

# XLA's min/max on the CPU, probed through the reference's interpret-mode
# network (ml_dtypes' and torch's bytes agree)

_F8 = ["float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz",
       "float8_e8m0fnu"]
_BYTE_KINDS = _F8 + ["int4", "uint4"]
#: 0 and the sign bit alone (±0, or the fnuz NaN), each format's NaNs and
#: infinities, subnormals, and 4-bit values with high-nibble bits set
_BYTE_SPECIALS = np.array([0x00, 0x80, 0x7F, 0xFF, 0x7E, 0xFE, 0x7C, 0xFC,
                           0x7D, 0x01, 0x81, 0x03, 0x83, 0x18, 0xF3],
                          np.uint8)


def _byte_keys(rng, shape):
    bits = rng.integers(0, 256, shape, dtype=np.uint8)
    m = rng.random(shape) < 0.4
    bits[m] = rng.choice(_BYTE_SPECIALS, int(m.sum()))
    return bits


def _byte_pair(name, bits):
    """(numpy array of the reference's dtype, tensor of the port's)."""
    return (bits.view(getattr(ml_dtypes, name)),
            torch.from_numpy(bits).view(getattr(torch, name)))


@pytest.mark.parametrize("name", _BYTE_KINDS)
@pytest.mark.parametrize("l", [1, 2, 16, 256])
def test_rows_plain_float8_and_int4_equal_reference(rng, name, l):
    """Every special encoding of the format (NaNs, ±0, infinities,
    subnormals, 4-bit high nibbles) in rows of 1..256 keys, keys only and
    with values: bytes equal to the reference's network."""
    j, t = _byte_pair(name, _byte_keys(rng, (5, l)))
    vals = np.arange(5 * l, dtype=np.int32).reshape(5, l)
    want = j_rows(jnp.asarray(j), interpret=True)
    want_kv = j_rows_kv(jnp.asarray(j), jnp.asarray(vals), interpret=True)
    got = tk.bitonic_sort_rows(t)
    assert got.dtype == t.dtype
    assert got.view(torch.uint8).numpy().tobytes() == np.asarray(
        want).view(np.uint8).tobytes()
    gk, gv = tk.bitonic_sort_rows_kv(t, _t(vals))
    assert gk.view(torch.uint8).numpy().tobytes() == np.asarray(
        want_kv[0]).view(np.uint8).tobytes()
    _same(gv, want_kv[1])


@pytest.mark.parametrize("name", _F8)
def test_rows_plain_float8_every_pair(name):
    """min and max of all 65 536 ordered pairs of encodings (rows of two:
    lane 0 gets min(x, y), lane 1 max(y, x)), and the move mask."""
    a = np.arange(256, dtype=np.uint8)
    x, y = np.meshgrid(a, a, indexing="ij")
    j, t = _byte_pair(name, np.stack([x.ravel(), y.ravel()], 1))
    vals = np.arange(j.size, dtype=np.int32).reshape(j.shape)
    want = j_rows_kv(jnp.asarray(j), jnp.asarray(vals), interpret=True)
    gk, gv = tk.bitonic_sort_rows_kv(t, _t(vals))
    assert gk.view(torch.uint8).numpy().tobytes() == np.asarray(
        want[0]).view(np.uint8).tobytes()
    _same(gv, want[1])


@pytest.mark.parametrize("name,row,want", [
    # e4m3fn: no inf, NaNs 0x7F / 0xFF propagate, -0 below +0, the
    # subnormal 0x01 kept
    ("float8_e4m3fn", [0x01, 0x80, 0x00, 0x38], [0x80, 0x00, 0x01, 0x38]),
    ("float8_e4m3fn", [0x38, 0xFF, 0x01, 0x00], [0xFF] * 4),
    # e5m2: every NaN becomes +NaN 0x7F; ±inf are 0xFC / 0x7C
    ("float8_e5m2", [0x7C, 0xFD, 0xFC, 0x00], [0x7F] * 4),
    ("float8_e5m2", [0x7C, 0x01, 0xFC, 0x80], [0xFC, 0x80, 0x01, 0x7C]),
    # fnuz: 0x80 is the one NaN (no -0)
    ("float8_e4m3fnuz", [0x10, 0x80, 0x90, 0x00], [0x80] * 4),
    ("float8_e5m2fnuz", [0x10, 0x81, 0x90, 0x00], [0x90, 0x81, 0x00, 0x10]),
    # e8m0fnu: no sign; 0xFF the NaN; where a min or max returns 0x00
    # (2^-127, zero to XLA) the result is the NaN, which then spreads
    ("float8_e8m0fnu", [0x00, 0x05], [0xFF, 0x05]),
    ("float8_e8m0fnu", [0x05, 0x00, 0x7F, 0x80], [0xFF] * 4),
    ("float8_e8m0fnu", [0x80, 0x05, 0x7F, 0x01], [0x01, 0x05, 0x7F, 0x80]),
    # 4-bit: the low nibble is the value, the high nibble dropped
    ("int4", [0x18, 0xF3, 0x07, 0x2F], [0x08, 0x0F, 0x03, 0x07]),
    ("uint4", [0x18, 0xF3, 0x07, 0x2F], [0x03, 0x07, 0x08, 0x0F]),
])
def test_rows_plain_byte_kinds_pinned(name, row, want):
    """What the probes found, pinned: the plain version and the reference
    both give these bytes."""
    j, t = _byte_pair(name, np.array([row], np.uint8))
    ref_out = np.asarray(j_rows(jnp.asarray(j), interpret=True))
    assert ref_out.view(np.uint8).tolist() == [want]
    assert tk.bitonic_sort_rows(t).view(torch.uint8).tolist() == [want]


def test_row_kind_takes_float8_and_int4():
    kinds = {name: tref.row_kind(getattr(torch, name))
             for name in _BYTE_KINDS}
    assert kinds == {"float8_e4m3fn": "e4m3fn", "float8_e5m2": "e5m2",
                     "float8_e4m3fnuz": "e4m3fnuz",
                     "float8_e5m2fnuz": "e5m2fnuz",
                     "float8_e8m0fnu": "e8m0fnu", "int4": "i4", "uint4": "u4"}
    with pytest.raises(TypeError, match="does not take"):
        tref.row_kind(torch.complex64)
    with pytest.raises(TypeError, match="oracle does not take"):
        tref.bitonic_sort_rows_ref(
            torch.zeros((1, 4), dtype=torch.float8_e4m3fn))


@pytest.mark.parametrize("name", ["int4", "uint4"])
def test_bitonic_sort_rows_oracle_4bit_equals_reference(rng, name):
    j, t = _byte_pair(name, _byte_keys(rng, (4, 64)))
    vals = np.arange(4 * 64, dtype=np.int32).reshape(4, 64)
    want = jref.bitonic_sort_rows_ref(jnp.asarray(j), jnp.asarray(vals))
    got = tref.bitonic_sort_rows_ref(t, _t(vals))
    assert got[0].view(torch.uint8).numpy().tobytes() == np.asarray(
        want[0]).view(np.uint8).tobytes()
    _same(got[1], want[1])
