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


# ---- the library surface: row network, multisplit, assigned histogram ----

def _bits_equal(a, b):
    from repro_torch.kernels.ref import int_view
    return a.dtype == b.dtype and torch.equal(int_view(a), int_view(b))


def _rows_input(rng, shape, dtype):
    """Keys of a torch dtype from numpy bits; floats mixed with random bit
    patterns (NaN payloads, subnormals, infinities) and signed zeros."""
    size = torch.empty((), dtype=dtype).element_size()
    u = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[size]
    bits = rng.integers(0, 2**63, shape, dtype=np.uint64).astype(u)
    t = torch.from_numpy(bits).view(dtype)
    if dtype.is_floating_point:
        normal = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        m = torch.from_numpy(rng.random(shape))
        t = torch.where(m < 0.7, normal, t)
        t = torch.where((m >= 0.7) & (m < 0.8), torch.zeros_like(t), t)
        t = torch.where((m >= 0.8) & (m < 0.9), -torch.zeros_like(t), t)
    elif dtype == torch.bool:
        t = torch.from_numpy(bits & u(1)).to(torch.bool)
    return t


ROW_DTYPES = [torch.uint32, torch.int32, torch.float32, torch.int64,
              torch.float64, torch.uint16, torch.bfloat16, torch.float16,
              torch.uint8, torch.int8, torch.bool, torch.uint64]


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
@pytest.mark.parametrize("length", [2, 64, 1024, 8192])
def test_rows_kernel_equals_plain(dev, dtype, length):
    from repro_torch.kernels import bitonic, ref
    rng = np.random.default_rng(length)
    keys = _rows_input(rng, (max(3, 65536 // length), length), dtype).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    assert _bits_equal(bitonic.bitonic_sort_rows(keys),
                       ref.bitonic_rows_ref(keys))
    gk, gv = bitonic.bitonic_sort_rows_kv(keys, vals)
    wk, wv = ref.bitonic_rows_ref(keys, vals)
    assert _bits_equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("vdtype", [torch.int8, torch.float16, torch.int64])
def test_rows_kv_kernel_value_dtypes_and_duplicates(dev, vdtype):
    from repro_torch.kernels import bitonic, ref
    gen = torch.Generator(device=dev).manual_seed(9)
    keys = torch.randint(0, 1000, (64, 16384), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint32)
    vals = torch.randint(-100, 100, keys.shape, generator=gen, device=dev,
                         dtype=torch.int64).to(vdtype)
    got = bitonic.bitonic_sort_rows_kv(keys, vals)
    want = ref.bitonic_rows_ref(keys, vals)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


def test_rows_kernel_refuses_a_row_over_shared_memory(dev):
    from repro_torch.kernels import bitonic
    keys = torch.zeros((1, 16384), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        bitonic.bitonic_sort_rows_kv(keys, keys.clone())


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.uint16,
                                   torch.int64, torch.uint64], ids=str)
@pytest.mark.parametrize("shift,width,key_bits", [(24, 8, 32), (0, 8, 16),
                                                  (28, 8, 32), (40, 5, 64),
                                                  (3, 1, 48)])
def test_multisplit_kernel_equals_plain(dev, dtype, shift, width, key_bits):
    from repro_torch.kernels import multisplit, ref
    rng = np.random.default_rng(shift * 7 + width)
    keys = _rows_input(rng, (40, 6912), dtype).to(dev)
    keys[3] = keys[3, :1]                       # one all-equal tile
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    got = multisplit.tile_multisplit(keys, shift, width, key_bits)
    want = ref.tile_multisplit_kv_ref(keys, None, shift, width, key_bits)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    got = multisplit.tile_multisplit_kv(keys, vals, shift, width, key_bits,
                                        16)
    want = ref.tile_multisplit_kv_ref(keys, vals, shift, width, key_bits, 16)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.int64],
                         ids=str)
def test_assigned_kernel_equals_plain(dev, dtype):
    from repro_torch.kernels import assigned, ref
    rng = np.random.default_rng(4)
    keys = _rows_input(rng, (50, 1024), dtype).to(dev)
    tile_idx = torch.from_numpy(np.concatenate([
        rng.permutation(50), [-1, -50, -51, 50, 2**31 - 1, -2**31, 7]])
        .astype(np.int32)).to(dev)
    valid = torch.ones_like(tile_idx)
    valid[-7:] = torch.tensor([1, 2, 1, -3, 1, 0, 0], dtype=torch.int32)
    for shift, width in ((24, 8), (28, 8), (0, 3)):
        got = assigned.assigned_histogram(keys, tile_idx, valid, shift,
                                          width)
        want = ref.assigned_histogram_ref(keys, tile_idx, valid, shift, width)
        assert torch.equal(got, want)


def test_tile_histogram_pass_on_card_equals_cpu(dev):
    from repro_torch.kernels import COUNTS, ops, reset_counts
    x = torch.from_numpy(_keys(np.random.default_rng(8), 100001))
    reset_counts()
    got = ops.tile_histogram_pass(x.to(dev), 24, 8, kpb=6912)
    assert COUNTS["histogram"] == 1
    want = ops.tile_histogram_pass(x, 24, 8, kpb=6912)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_library_kernels_refuse_widths_above_8(dev):
    from repro_torch.kernels import assigned, histogram, multisplit
    keys = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="widths 1..8"):
        multisplit.tile_multisplit(keys, 0, 9, 32)
    with pytest.raises(ValueError, match="widths 1..8"):
        assigned.assigned_histogram(keys, idx, idx, 0, 9)
    with pytest.raises(ValueError, match="widths 1..8"):
        histogram.radix_histogram(keys, 0, 9)
