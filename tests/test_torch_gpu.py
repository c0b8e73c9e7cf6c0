"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports neither JAX nor the
reference (the GPU machine need not have them); the kernels' plain versions
are held to the reference by ``test_torch_kernels.py``.  Run on a GPU with

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _keys(rng, n, ands=0):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    for _ in range(ands):
        x &= rng.integers(0, 2**32, n, dtype=np.uint32)
    return x


@pytest.mark.parametrize("ands", [0, 3, 30])
def test_histogram_kernel_equals_plain(dev, ands):
    from repro_torch.kernels import histogram, ref
    x = torch.from_numpy(_keys(np.random.default_rng(ands), 1 << 16, ands)
                         .view(np.int32)).to(dev)
    for shift, width in ((24, 8), (0, 8), (8, 5), (28, 4)):
        tiles = x.reshape(-1, 1024)
        assert torch.equal(histogram.radix_histogram(tiles, shift, width),
                           ref.radix_histogram_ref(tiles, shift, width))
        total = histogram.digit_total(x, x.numel() - 5, shift, width)
        want = ref.radix_histogram_ref(x[:-5].reshape(1, -1), shift, width)
        assert torch.equal(total, want[0])


@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int64])
@pytest.mark.parametrize("ands", [0, 3])
@pytest.mark.parametrize("adaptive", [True, False])
def test_hybrid_sort_on_card_equals_cpu(dev, dtype, ands, adaptive):
    from repro_torch import SortConfig, hybrid_sort
    cfg = SortConfig(d=8, kpb=256, local_threshold=300, merge_threshold=200)
    rng = np.random.default_rng(7)
    bits = _keys(rng, 50000, ands)
    if dtype == np.int64:
        x = (bits.astype(np.int64) << 31) ^ rng.integers(0, 2**31, 50000)
    else:
        x = bits.view(dtype)
    vals = np.arange(x.size, dtype=np.int32)
    got_k, got_v, got_s = hybrid_sort(x, vals, cfg=cfg, adaptive=adaptive,
                                      return_stats=True)
    want_k, want_v, want_s = hybrid_sort(x, vals, cfg=cfg, engine="kernel",
                                         adaptive=adaptive,
                                         return_stats=True, device="cpu")
    assert got_k.device.type == "cuda"
    assert got_k.cpu().numpy().tobytes() == want_k.numpy().tobytes()
    assert torch.equal(got_v.cpu(), want_v)
    assert tuple(got_s) == tuple(want_s)


def test_local_sort_rows_kernel_equals_plain(dev):
    from repro_torch.kernels import bitonic, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    for length in (32, 1024, 16384):
        keys = torch.randint(0, 50, (8, length), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randperm(8 * length, generator=gen, device=dev).to(
            torch.int32).reshape(8, length)
        got = bitonic.bitonic_sort_rows_stable(keys, idx)
        want = ref.bitonic_sort_rows_stable_ref(keys, idx)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
