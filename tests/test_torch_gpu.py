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


def _merge_case(dev, runs, kway, tile, leaf_dtypes):
    """A real round's tables over ``runs`` (carrier int32/int64 tensors on
    the card) and value leaves of ``leaf_dtypes``; the kernel and the plain
    version on the same buffers must agree on [0, n)."""
    from repro_torch.kernels import merge, ref
    from repro_torch.kernels.fused import pad_length
    lens = [r.numel() for r in runs]
    n = sum(lens)
    n_pad = pad_length(n, tile)
    keys = torch.cat(runs + [runs[0].new_full((n_pad - n,), -1)])
    gen = torch.Generator(device=dev).manual_seed(n)
    vals = tuple(torch.randint(-2**31, 2**31 - 1, (n_pad,), generator=gen,
                               device=dev, dtype=torch.int64).to(dt)
                 for dt in leaf_dtypes)
    tables = merge.merge_path_partition(keys, lens, kway, tile)
    outs = []
    for fn in (merge.kway_merge_round, ref.kway_merge_round_ref):
        alt_k = torch.full_like(keys, -1)
        alt_v = tuple(torch.zeros_like(v) for v in vals)
        outs.append(fn(keys, vals, alt_k, alt_v, *tables, kway=kway,
                       tpb=tile, n=n))
    torch.cuda.synchronize()
    (gk, gv), (wk, wv) = outs
    assert torch.equal(gk[:n], wk[:n])
    for a, b in zip(gv, wv):
        assert torch.equal(a[:n], b[:n])
    return gk[:n]


def _sorted_runs(dev, lens, dtype, hi, seed):
    from repro_torch.core import bijection
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for m in lens:
        x = torch.randint(0, hi, (m,), generator=gen, device=dev,
                          dtype=torch.int64).to(dtype)
        # carrier bits sorted in key order: sort the sortable view
        out.append(bijection.sortable(torch.sort(bijection.sortable(x))
                                      .values))
    return out


@pytest.mark.parametrize("kway", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("leaves", [(), (torch.int32,),
                                    (torch.int64, torch.int32)])
def test_merge_kernel_equals_plain(dev, kway, dtype, leaves):
    from repro_torch.core import bijection
    tile = 256
    lens = [3000, 17, 0, 2048, 999, 1, 4000, 513][:kway] + [700, 64]
    runs = _sorted_runs(dev, lens, dtype, 2**40, kway)
    out = _merge_case(dev, runs, kway, tile, leaves)
    if len(lens) <= kway:
        s = bijection.sortable(out)
        assert bool((s[1:] >= s[:-1]).all())


@pytest.mark.parametrize("case", ["all_equal", "sentinel", "single_run"])
def test_merge_kernel_degenerate_runs(dev, case):
    tile = 128
    if case == "all_equal":
        runs = [torch.full((m,), 7, dtype=torch.int32, device=dev)
                for m in (500, 130, 0, 257)]
    elif case == "sentinel":
        runs = _sorted_runs(dev, (300, 222, 91), torch.int32, 9, 1)
        runs = [torch.where(torch.arange(r.numel(), device=dev) >
                            r.numel() // 2, torch.full_like(r, -1), r)
                for r in runs]
    else:
        runs = _sorted_runs(dev, (1000,), torch.int32, 2**31, 2)
    _merge_case(dev, runs, 4, tile, (torch.int32,))


def test_merge_kernel_refuses_too_much_shared_memory(dev):
    from repro_torch.kernels import merge
    keys = torch.zeros(8 * 4096 * 2, dtype=torch.int64, device=dev)
    t = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        merge.kway_merge_round(keys, (), keys.clone(), (), t, t, t.repeat(8),
                               t.repeat(8), kway=8, tpb=4096, n=8)


@pytest.mark.parametrize("spill", [False, True])
def test_oocsort_on_card_equals_cpu(dev, spill):
    from repro_torch import SortConfig, oocsort
    cfg = SortConfig(d=8, kpb=256, local_threshold=300, merge_threshold=200)
    rng = np.random.default_rng(5)
    x = _keys(rng, 300000, 1)
    v = np.arange(x.size, dtype=np.uint32)
    kw = dict(cfg=cfg, tile=512, return_stats=True)
    if spill:
        kw["device_slab_elems"] = 20000
    got = oocsort(x, 40000, values=v, **kw)
    want = oocsort(x, 40000, values=v, engine="kernel", device="cpu", **kw)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2] == want[2]
    assert got[0].tobytes() == np.sort(x, kind="stable").tobytes()
