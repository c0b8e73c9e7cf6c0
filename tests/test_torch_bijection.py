"""The port's ordered-bits carrier against the reference bijection.

The carrier's bit pattern must equal ``repro.core.bijection``'s unsigned
ordered key for every supported dtype (bf16 and fp16 included), round-trip
every bit pattern (NaN payloads, both zeros), and sort in the reference's
order once the top bit is flipped.  ``CompressionPlan`` packing must equal
the reference's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core import bijection as jb  # noqa: E402
from repro_torch.core import bijection as tb  # noqa: E402
from repro_torch.core.interop import to_numpy, to_tensor  # noqa: E402

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
          np.int32, np.int64, np.float32, np.float64, ml_dtypes.bfloat16,
          np.float16]
_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _patterns(rng, dtype, n=2048):
    """Random bit patterns of ``dtype`` plus the float specials: both
    zeros, both infinities, NaNs of both signs with payloads."""
    dt = np.dtype(dtype)
    udt = _UNSIGNED[dt.itemsize]
    bits = rng.integers(0, np.iinfo(udt).max, n, dtype=udt, endpoint=True)
    x = bits.view(dt)
    if dt.kind == "f" or dt.name == "bfloat16":
        top = 1 << (8 * dt.itemsize - 1)
        exp = {2: 0x7C00 if dt.name == "float16" else 0x7F80,
               4: 0x7F800000, 8: 0x7FF0000000000000}[dt.itemsize]
        special = np.array([0, top, exp, top | exp, exp | 1, top | exp | 1,
                            exp | (exp >> 1), top | exp | 3],
                           dtype=udt)
        bits = bits.copy()
        bits[:special.size] = special
        x = bits.view(dt)
    return x


def _carrier_bits(t):
    """The carrier's values as the reference's unsigned bits."""
    arr = to_numpy(t)
    return arr.view(_UNSIGNED[arr.dtype.itemsize])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_carrier_bits_equal_reference(rng, dtype):
    x = _patterns(rng, dtype)
    want = jb.to_ordered_bits_np(x)
    t = to_tensor(x, "cpu")
    carrier = tb.to_ordered_bits(t)
    assert carrier.dtype == tb.carrier_dtype(t.dtype)
    assert _carrier_bits(carrier).tobytes() == want.tobytes()
    assert tb.to_ordered_bits_np(x).tobytes() == want.tobytes()
    assert tb.key_bits(t.dtype) == tb.key_bits(x.dtype) == jb.key_bits(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_round_trip_every_pattern(rng, dtype):
    x = _patterns(rng, dtype)
    t = to_tensor(x, "cpu")
    back = tb.from_ordered_bits(tb.to_ordered_bits(t), t.dtype)
    assert back.dtype == t.dtype
    assert to_numpy(back).tobytes() == np.ascontiguousarray(x).tobytes()
    ubits = tb.to_ordered_bits_np(x)
    assert tb.from_ordered_bits_np(ubits, x.dtype).tobytes() == \
        jb.from_ordered_bits_np(ubits, x.dtype).tobytes()


@pytest.mark.parametrize("dtype", [np.int8, np.uint32, np.int32, np.float32,
                                   np.int64, np.float64, ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_sortable_order_is_reference_order(rng, dtype):
    """Flipping the carrier's top bit gives the reference's unsigned order,
    keys with the top bit set included."""
    x = _patterns(rng, dtype)
    carrier = tb.to_ordered_bits(to_tensor(x, "cpu"))
    got = torch.sort(tb.sortable(carrier), stable=True).indices.numpy()
    want = np.argsort(jb.to_ordered_bits_np(x), kind="stable")
    assert np.array_equal(got, want)


def test_float_total_order_specials():
    x = np.array([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -1.0],
                 np.float32)
    x[0] = np.array([0xFFC00001], np.uint32).view(np.float32)[0]   # -NaN
    carrier = tb.to_ordered_bits(to_tensor(x, "cpu"))
    order = torch.sort(tb.sortable(carrier), stable=True).indices.numpy()
    got = x[order].view(np.uint32)
    want = np.array([0xFFC00001, 0xFF800000, 0xBF800000, 0x80000000, 0,
                     0x3F800000, 0x7F800000], np.uint32)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype,shift", [(np.uint64, 40), (np.uint32, 7),
                                         (np.int16, 0), (np.uint64, 0)])
def test_compression_plan_pack_unpack(rng, dtype, shift):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, 3000, dtype=dtype, endpoint=True)
    x = (x >> dtype(shift)) | dtype(0b100)     # dead high bits, a dead 1
    ubits = jb.to_ordered_bits_np(x)
    want_plan = jb.compression_plan_np(ubits)
    carrier = tb.to_ordered_bits(to_tensor(x, "cpu"))
    plan = tb.compression_plan(carrier)
    assert tuple(plan) == tuple(want_plan)
    assert tb.compression_plan_np(ubits) == plan
    packed = tb.pack_ordered_bits(carrier, plan)
    want_packed = jb.pack_ordered_bits_np(ubits, want_plan)
    assert packed.dtype == tb.packed_carrier_dtype(plan)
    assert _carrier_bits(packed).tobytes() == want_packed.tobytes()
    assert tb.pack_ordered_bits_np(ubits, plan).tobytes() == \
        want_packed.tobytes()
    back = tb.unpack_ordered_bits(packed, plan)
    assert _carrier_bits(back).tobytes() == ubits.tobytes()
    assert tb.unpack_ordered_bits_np(want_packed, plan).tobytes() == \
        ubits.tobytes()


def test_compression_plan_edge_cases():
    empty = torch.zeros(0, dtype=torch.int32)
    assert tuple(tb.compression_plan(empty)) == \
        tuple(jb.compression_plan_np(np.zeros(0, np.uint32)))
    same = torch.full((17,), -5, dtype=torch.int32)
    plan = tb.compression_plan(same)
    assert tuple(plan) == tuple(jb.compression_plan_np(
        np.full(17, -5, np.int32).view(np.uint32)))
    assert plan.packed_bits == 1
    packed = tb.pack_ordered_bits(same, plan)
    assert torch.equal(tb.unpack_ordered_bits(packed, plan), same)


def test_bit_summary_matches_numpy(rng):
    for n in (1, 2, 3, 1000, 1023):
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        u = x.view(np.uint32)
        assert tb.bit_summary(torch.from_numpy(x)) == (
            int(np.bitwise_or.reduce(u)), int(np.bitwise_and.reduce(u)))
