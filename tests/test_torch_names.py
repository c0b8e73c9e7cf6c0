"""The reference's last public names without a port counterpart, each held
to the reference: ``core``'s fault re-exports,
``bijection.source_carrier_dtype`` and ``models.layers.np_sqrt``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore  # noqa: E402
from repro.core import bijection as rbij  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import bijection as tbij  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

FAULT_NAMES = ["FaultPolicy", "RetryPolicy", "FatalFault",
               "RetriesExhausted", "ChecksumError", "FAULT_SITES",
               "host_checksum"]


@pytest.mark.parametrize("name", FAULT_NAMES)
def test_core_reexports_the_fault_names(name):
    assert name in rcore.__all__ and name in tcore.__all__
    from repro_torch.core import faults
    assert getattr(tcore, name) is getattr(faults, name)


def test_fault_sites_and_checksum_equal_the_reference():
    assert tcore.FAULT_SITES == rcore.FAULT_SITES
    rng = np.random.default_rng(3)
    for dt in (np.uint8, np.int16, np.uint32, np.float32, np.uint64):
        a = rng.integers(0, 200, 1001).astype(dt)
        assert tcore.host_checksum(a) == rcore.host_checksum(a)
    for cls in ("FatalFault", "RetriesExhausted", "ChecksumError"):
        assert issubclass(getattr(tcore, cls), Exception)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
def test_source_carrier_dtype_equals_the_reference(dtype):
    rng = np.random.default_rng(5)
    bits = np.iinfo(dtype).bits
    ubits = rng.integers(0, 2 ** min(bits, 63), 500, dtype=np.uint64) \
        .astype(dtype) & dtype((1 << (bits - 1)) | 0xF0)
    rplan = rbij.compression_plan_np(ubits)
    tplan = tbij.compression_plan_np(ubits)
    assert tuple(tplan) == tuple(rplan)
    want = rbij.source_carrier_dtype(rplan)
    assert tbij.source_carrier_dtype_np(tplan) == want
    carrier = tbij.source_carrier_dtype(tplan)
    # the port's carrier is the signed twin of the reference's dtype
    assert carrier.is_signed and not carrier.is_floating_point
    assert torch.empty((), dtype=carrier).element_size() == want.itemsize
    packed = tbij.pack_ordered_bits_np(ubits, tplan)
    assert np.array_equal(packed, rbij.pack_ordered_bits_np(ubits, rplan))
    back = tbij.unpack_ordered_bits(torch.from_numpy(
        packed.astype(packed.dtype.str.replace("u", "i"))), tplan)
    assert back.dtype == carrier
    assert np.array_equal(back.numpy().view(want), ubits)


@pytest.mark.parametrize("x", [0, 1, 2, 0.25, 1e6, 12288])
def test_np_sqrt_equals_the_reference(x):
    assert tlayers.np_sqrt(x) == rlayers.np_sqrt(x)
