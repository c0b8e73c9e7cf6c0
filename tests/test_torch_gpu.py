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


_MERGE_LEAVES = ((), (torch.int32,), (torch.int8, torch.int64, torch.int16),
                 (torch.int8, torch.int16, torch.int32, torch.int64,
                  torch.float16, torch.bfloat16, torch.float32,
                  torch.float64))
_CARRIER = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.mark.parametrize("kway", range(1, 9))
@pytest.mark.parametrize("tile", [256, 4096])
@pytest.mark.parametrize("key_bytes", [1, 2, 4, 8])
def test_merge_kernel_kway_tiles_and_widths(dev, kway, tile, key_bytes):
    """kway 1-8 at tiles 256 and 4096, keys of 1/2/4/8 bytes with 0, 1, 3
    or 8 value leaves (by kway), runs of uneven and empty lengths, and
    duplicate-heavy keys for the narrow widths.  kway 7 with 8-byte keys at
    tile 4096 leaves no room for the tree's output table (the round runs
    the short-tile kernel); kway 8 there is over shared memory and
    refused."""
    lens = [9000, 17, 0, 5000, 999, 1, 7000, 513][:kway]
    if kway == 1:
        lens = [9001]
    from repro_torch.kernels import merge
    hi = 2 ** min(8 * key_bytes - 1, 40)
    runs = _sorted_runs(dev, lens, _CARRIER[key_bytes], hi, kway * tile)
    if merge.smem_bytes(kway, tile, key_bytes) > merge.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            _merge_case(dev, runs, kway, tile, ())
        return
    _merge_case(dev, runs, kway, tile, _MERGE_LEAVES[kway % 4])


@pytest.mark.parametrize("kernel", ["small", "tree"])
@pytest.mark.parametrize("tile", [256, 4096])
def test_merge_probe_kernels_equal_plain(dev, kernel, tile):
    """The two kernels the timing probe forces compute the same round."""
    from repro_torch.kernels import merge, ref
    from repro_torch.kernels.fused import pad_length
    runs = _sorted_runs(dev, [9000, 17, 5000, 999], torch.int32, 2**31, 4)
    lens = [r.numel() for r in runs]
    n = sum(lens)
    keys = torch.cat(runs + [runs[0].new_full((pad_length(n, tile) - n,),
                                              -1)])
    vals = (torch.arange(keys.numel(), dtype=torch.int32, device=dev),)
    tables = merge.merge_path_partition(keys, lens, 4, tile)
    got = merge._kway_merge_probe(
        keys, vals, torch.full_like(keys, -1), (torch.zeros_like(vals[0]),),
        *tables, kway=4, tpb=tile, kernel=kernel)
    want = ref.kway_merge_round_ref(
        keys, vals, torch.full_like(keys, -1), (torch.zeros_like(vals[0]),),
        *tables, kway=4, tpb=tile, n=n)
    assert torch.equal(got[0][:n], want[0][:n])
    assert torch.equal(got[1][0][:n], want[1][0][:n])


def test_merge_kernel_dead_tiles_and_short_counts(dev):
    """A spill strip's zero-count padding tiles, and tiles whose out_cnt is
    below their live lanes (ranks past it write nothing): the kernel and
    the plain version write the same slots."""
    from repro_torch.kernels import merge, ref
    tile, kway, slab = 256, 4, 4096
    host = [np.sort(np.random.default_rng(r).integers(0, 500, m)).astype(
        np.uint32) for r, m in enumerate((1000, 700, 1, 1500))]
    strips = merge.spill_group_plan(host, kway, tile, slab)
    assert any((s.tables[1] == 0).any() for s in strips)
    for strip in strips:
        wins = [h[lo:lo + ln] for h, lo, ln in zip(host, strip.win_lo,
                                                   strip.win_len)]
        buf = np.concatenate(wins + [np.full(slab + tile - strip.out_len,
                                             0xFFFFFFFF, np.uint32)])
        keys = torch.from_numpy(buf.view(np.int32)).to(dev)   # the carrier
        for cut in (False, True):
            tables = [torch.from_numpy(t.copy()).to(dev)
                      for t in strip.tables]
            if cut:
                tables[1] = torch.clamp(tables[1] - 37, min=0)
            vals = (torch.arange(keys.numel(), dtype=torch.int32,
                                 device=dev),)
            outs = []
            for fn in (merge.kway_merge_round, ref.kway_merge_round_ref):
                ak = torch.full_like(keys, -1)
                av = (torch.full_like(vals[0], -1),)
                outs.append(fn(keys, vals, ak, av, *tables, kway=kway,
                               tpb=tile, n=slab))
            torch.cuda.synchronize()
            (gk, gv), (wk, wv) = outs
            assert torch.equal(gk[:slab], wk[:slab])
            assert torch.equal(gv[0][:slab], wv[0][:slab])


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


_BYTE_KINDS = [torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e4m3fnuz,
               torch.float8_e5m2fnuz, torch.float8_e8m0fnu, torch.int4,
               torch.uint4]
#: encodings every one-byte kind has a rule for: 0 and the sign bit alone
#: (±0, or the fnuz NaN), the NaNs / infinities at the top of each format,
#: subnormals, and 4-bit values with high-nibble bits set
_BYTE_SPECIALS = np.array([0x00, 0x80, 0x7F, 0xFF, 0x7E, 0xFE, 0x7C, 0xFC,
                           0x7D, 0x01, 0x81, 0x03, 0x83, 0x18, 0xF3],
                          np.uint8)


def _byte_rows(rng, shape, dtype):
    bits = rng.integers(0, 256, shape, dtype=np.uint8)
    m = rng.random(shape) < 0.3
    bits[m] = rng.choice(_BYTE_SPECIALS, int(m.sum()))
    return torch.from_numpy(bits).view(dtype)


@pytest.mark.parametrize("dtype", _BYTE_KINDS + [torch.uint32, torch.int32,
                                                 torch.int16, torch.float32,
                                                 torch.bfloat16,
                                                 torch.int64], ids=str)
@pytest.mark.parametrize("length", [2, 4, 32, 256, 2048, 4096, 16384])
def test_rows_kernel_every_kind_and_length(dev, dtype, length):
    """Every compare kind the network takes (the float8 formats and the
    4-bit integers with their special encodings), rows of 2..16384 keys:
    short rows share a CTA, 16384 gives each thread two lane groups."""
    from repro_torch.kernels import bitonic, ref
    rng = np.random.default_rng(length + 7)
    shape = (max(3, (1 << 17) // length) + 1, length)
    keys = (_byte_rows(rng, shape, dtype) if dtype in _BYTE_KINDS
            else _rows_input(rng, shape, dtype)).to(dev)
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


@pytest.mark.parametrize("width", range(9, 17))
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int64], ids=str)
def test_library_kernels_widths_9_to_16_equal_plain(dev, width, dtype):
    """The multisplit (keys and KV: two 8-bit rounds, 16-bit digits, run
    starts from the digit changes, sparse histogram rows), the assigned
    histogram (one shared table up to 14 bits, global atomics past it) and
    the histogram rows at widths 9..16, against their plain versions."""
    from repro_torch.kernels import assigned, histogram, multisplit, ref
    rng = np.random.default_rng(width)
    keys = _rows_input(rng, (24, 6912), dtype).to(dev)
    keys[5] = keys[5, :1]                       # one all-equal tile
    bits = 8 * keys.element_size()
    shift = bits - width - 2
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    got = multisplit.tile_multisplit(keys, shift, width, bits)
    want = ref.tile_multisplit_kv_ref(keys, None, shift, width, bits)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    got = multisplit.tile_multisplit_kv(keys, vals, shift, width, bits, 32)
    want = ref.tile_multisplit_kv_ref(keys, vals, shift, width, bits, 32)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    tile_idx = torch.tensor([3, 5, 0, -1, 40, 23, 7], dtype=torch.int32,
                            device=dev)
    valid = torch.tensor([1, 2, 1, -3, 1, 0, 1], dtype=torch.int32,
                         device=dev)
    assert torch.equal(
        assigned.assigned_histogram(keys, tile_idx, valid, shift, width),
        ref.assigned_histogram_ref(keys, tile_idx, valid, shift, width))
    assert torch.equal(histogram.radix_histogram(keys, shift, width),
                       ref.radix_histogram_ref(keys, shift, width))


def test_multisplit_refuses_a_tile_over_shared_memory(dev):
    """A tile whose staging buffer does not fit one CTA is refused by the
    launch, with the limit named."""
    from repro_torch.kernels import multisplit
    keys = torch.zeros((1, 32768), dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="shared memory"):
        multisplit.tile_multisplit_kv(keys, keys.clone(), 0, 8, 64, 64)


def test_library_kernels_refuse_width_17(dev):
    """digit_at takes at most 16 bits: every kernel refuses width 17."""
    from repro_torch.kernels import assigned, histogram, multisplit
    keys = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="widths 1..16"):
        multisplit.tile_multisplit(keys, 0, 17, 32)
    with pytest.raises(ValueError, match="widths 1..16"):
        assigned.assigned_histogram(keys, idx, idx, 0, 17)
    with pytest.raises(ValueError, match="widths 1..16"):
        histogram.radix_histogram(keys, 0, 17)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
@pytest.mark.parametrize("kpb", [6911, 6910, 6912])
def test_multisplit_kernel_unaligned_tiles_equal_plain(dev, dtype, kpb):
    """Width 8 on tiles whose starts are not 16-byte aligned (KPB 6911 and
    6910 with 4-byte keys, every row start shifted; a view one key in), so
    the vector loads' and stores' scalar heads and tails run."""
    from repro_torch.kernels import multisplit, ref
    rng = np.random.default_rng(kpb)
    flat = _rows_input(rng, (30 * kpb + 1,), dtype).to(dev)
    vals = torch.arange(30 * kpb + 1, dtype=torch.int32, device=dev)
    bits = 8 * flat.element_size()
    for k, v in ((flat[:-1], vals[:-1]), (flat[1:], vals[1:])):
        keys, vk = k.view(30, kpb), v.view(30, kpb)
        got = multisplit.tile_multisplit(keys, bits - 8, 8, bits)
        want = ref.tile_multisplit_kv_ref(keys, None, bits - 8, 8, bits)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        got = multisplit.tile_multisplit_kv(keys, vk, bits - 11, 8, bits, 32)
        want = ref.tile_multisplit_kv_ref(keys, vk, bits - 11, 8, bits, 32)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["all_equal", "distinct"])
def test_multisplit_kernel_16bit_edge_tiles_equal_plain(dev, case):
    """Width 16: an all-equal tile (one run) and a tile of 6912 distinct
    digits (6912 runs of one key), keys and KV."""
    from repro_torch.kernels import multisplit, ref
    rng = np.random.default_rng(16)
    if case == "all_equal":
        x = np.full((3, 6912), 0xBEEF1234, np.uint32)
    else:
        x = np.stack([rng.permutation(65536)[:6912].astype(np.uint32) << 8
                      for _ in range(3)])
    keys = torch.from_numpy(x).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    got = multisplit.tile_multisplit_kv(keys, vals, 8, 16, 32, 32)
    want = ref.tile_multisplit_kv_ref(keys, vals, 8, 16, 32, 32)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    if case == "distinct":
        assert bool((got[3] == 0).all())           # every run one key long


@pytest.mark.parametrize("d", [10, 12, 16])
@pytest.mark.parametrize("ands", [0, 3])
def test_hybrid_sort_wide_digits_on_card_equals_cpu(dev, d, ands):
    """d = 10..16 through the fused pass's wide variant and the wide
    histogram: keys, values and stats equal to the plain versions' run on
    the CPU, one histogram and one fused launch per executed pass."""
    from repro_torch import SortConfig, hybrid_sort
    from repro_torch.kernels import COUNTS, reset_counts
    cfg = SortConfig(d=d, kpb=384, local_threshold=30, merge_threshold=20)
    rng = np.random.default_rng(d)
    x = _keys(rng, 20000, ands)
    vals = np.arange(x.size, dtype=np.int32)
    reset_counts()
    got_k, got_v, got_s = hybrid_sort(x, vals, cfg=cfg, return_stats=True)
    torch.cuda.synchronize()
    assert COUNTS["histogram"] == 1
    assert COUNTS["fused_pass"] == got_s.counting_passes >= 1 + (ands > 0)
    want_k, want_v, want_s = hybrid_sort(x, vals, cfg=cfg, engine="kernel",
                                         return_stats=True, device="cpu")
    assert got_k.cpu().numpy().tobytes() == want_k.numpy().tobytes()
    assert torch.equal(got_v.cpu(), want_v)
    assert tuple(got_s) == tuple(want_s)
    assert got_k.cpu().numpy().tobytes() == np.sort(x).tobytes()


@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
@pytest.mark.parametrize("ands", [0, 3])
def test_hybrid_sort_9bit_digits_on_card_equals_cpu(dev, dtype, ands):
    """d = 9 (r = 512) through the fused pass and the histogram: keys,
    values and stats equal to the plain versions' run on the CPU, one fused
    launch per executed pass."""
    from repro_torch import SortConfig, hybrid_sort
    from repro_torch.kernels import COUNTS, reset_counts
    cfg = SortConfig(d=9, kpb=384, local_threshold=300, merge_threshold=200)
    rng = np.random.default_rng(9)
    bits = _keys(rng, 60000, ands)
    x = ((bits.astype(np.int64) << 31) ^ rng.integers(0, 2**31, bits.size)
         if dtype == np.int64 else bits)
    vals = np.arange(x.size, dtype=np.int32)
    reset_counts()
    got_k, got_v, got_s = hybrid_sort(x, vals, cfg=cfg, return_stats=True)
    torch.cuda.synchronize()
    assert COUNTS["histogram"] == 1
    assert COUNTS["fused_pass"] == got_s.counting_passes
    want_k, want_v, want_s = hybrid_sort(x, vals, cfg=cfg, engine="kernel",
                                         return_stats=True, device="cpu")
    assert got_k.cpu().numpy().tobytes() == want_k.numpy().tobytes()
    assert torch.equal(got_v.cpu(), want_v)
    assert tuple(got_s) == tuple(want_s)
    assert got_k.cpu().numpy().tobytes() == np.sort(x).tobytes()


@pytest.mark.parametrize("key_bytes", [2, 4, 8])
def test_histogram_9bit_digits_equal_plain(dev, key_bytes):
    """r = 512 in both modes of the histogram (the whole-array total and
    the (T, r) rows), on aligned and unaligned views."""
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(90 + key_bytes)
    bits = 8 * key_bytes
    t = _carrier(rng.integers(0, 2**bits, 70001,
                              dtype=_KEY_DTYPES[key_bytes])).to(dev)
    for shift in (bits - 9, 0, 3):
        for view, n in ((t, t.numel()), (t[1:], 4097), (t[3:], 17)):
            got = histogram.digit_total(view, n, shift, 9)
            want = ref.radix_histogram_ref(view[:n].reshape(1, -1), shift,
                                           9)[0]
            assert torch.equal(got, want), (shift, n)
        tiles = t[:103 * 679].reshape(-1, 103)
        assert torch.equal(histogram.radix_histogram(tiles, shift, 9),
                           ref.radix_histogram_ref(tiles, shift, 9))


# ---- the redesigned histogram and fused pass (vector loads, match-free
# counting, packed look-back, staged scatter) ------------------------------

_KEY_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _carrier(a):
    """numpy unsigned keys -> the carrier tensor (signed twin, same bits)."""
    return torch.from_numpy(a.view(np.dtype(f"i{a.dtype.itemsize}")))


@pytest.mark.parametrize("key_bytes", [2, 4, 8])
@pytest.mark.parametrize("keys", ["uniform", "all_equal"])
def test_histogram_wide_digits_equal_plain(dev, key_bytes, keys):
    """Widths 10..16 in both modes: one shared table per CTA up to 14
    bits; past it global atomics into the rows (zeroed by their CTA) and,
    for the total, bins split into parts of 2^14 with a shared table each;
    on aligned and unaligned views."""
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(160 + key_bytes)
    bits = 8 * key_bytes
    x = rng.integers(0, 2**bits, 70001, dtype=_KEY_DTYPES[key_bytes])
    if keys == "all_equal":
        x[:] = x[0]
    t = _carrier(x).to(dev)
    for width in range(10, 17):
        if width > bits:
            continue
        shift = bits - width
        for view, n in ((t, t.numel()), (t[1:], 4097), (t[3:], 17)):
            got = histogram.digit_total(view, n, shift, width)
            want = ref.radix_histogram_ref(view[:n].reshape(1, -1), shift,
                                           width)[0]
            assert torch.equal(got, want), (width, n)
        tiles = t[:103 * 679].reshape(-1, 103)
        assert torch.equal(histogram.radix_histogram(tiles, shift, width),
                           ref.radix_histogram_ref(tiles, shift, width))


@pytest.mark.parametrize("key_bytes", [1, 2, 4, 8])
@pytest.mark.parametrize("keys", ["uniform", "all_equal", "and3"])
def test_histogram_vector_paths_equal_plain(dev, key_bytes, keys):
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(key_bytes)
    bits = 8 * key_bytes
    x = rng.integers(0, 2**bits, 70001, dtype=_KEY_DTYPES[key_bytes])
    if keys == "all_equal":
        x[:] = x[0]
    elif keys == "and3":
        for _ in range(3):
            x &= rng.integers(0, 2**bits, x.size, dtype=x.dtype)
    t = _carrier(x).to(dev)
    for width in range(1, 9):
        shift = bits - width
        # odd n, unaligned starts (views 1..3 keys in), a short tail
        for view, n in ((t, t.numel()), (t[1:], 4097), (t[3:], 17),
                        (t[1:], 3), (t[2:], t.numel() - 2)):
            got = histogram.digit_total(view, n, shift, width)
            want = ref.radix_histogram_ref(view[:n].reshape(1, -1), shift,
                                           width)[0]
            assert torch.equal(got, want), (width, n)
        tiles = t[:103 * 679].reshape(-1, 103)       # rows of odd length
        assert torch.equal(histogram.radix_histogram(tiles, shift, width),
                           ref.radix_histogram_ref(tiles, shift, width))


_LEAF_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _pass_inputs(dev, rng, n, key_bytes, d, pass_idx, bounds, a_max, kpb,
                 n_leaves, all_equal=False, x=None):
    """One pass's buffers and tables: keys of ``key_bytes`` (random, or the
    given ``x``) in the given active segments (``bounds``: (base, size)),
    ``n_leaves`` value leaves of mixed widths, the tables of
    ``plan.make_region_blocks`` and a next-segment map with some done
    buckets."""
    from repro_torch.core import plan
    from repro_torch.kernels import fused
    bits = 8 * key_bytes
    if x is None:
        x = rng.integers(0, 2**bits, n, dtype=_KEY_DTYPES[key_bytes])
    if all_equal:
        x[:] = x[n // 2]
    sc = plan.digit_window(pass_idx, bits, d)
    lo, width = sc[0], sc[1]
    r = 1 << d
    base = np.array([b for b, _ in bounds] + [n] * (a_max - len(bounds)),
                    np.int32)
    size = np.array([s for _, s in bounds] + [0] * (a_max - len(bounds)),
                    np.int32)
    hist = np.zeros((a_max, r), np.int64)
    for i, (b, s) in enumerate(bounds):
        dig = (x[b:b + s] >> np.array(lo, x.dtype)) & np.array(
            (1 << width) - 1, x.dtype)
        hist[i] = np.bincount(dig.astype(np.int64), minlength=r)
    base_excl = (base[:, None] + np.cumsum(hist, 1) - hist).astype(np.int32)
    nsid = rng.integers(0, a_max + 2, a_max * r).astype(np.int32)
    blocks = plan.make_region_blocks(
        torch.from_numpy(base).to(dev), torch.from_numpy(size).to(dev), n,
        kpb, plan.max_region_blocks(n, kpb, a_max))
    leaves = tuple(
        torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(dev)
        .to(torch.int64).view(torch.float64).to(dt) if dt.is_floating_point
        else torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(dev).to(dt)
        for dt in _LEAF_DTYPES[:n_leaves])
    (ck, cv), _ = fused.make_ping_pong(_carrier(x).to(dev), leaves, kpb)
    return dict(keys=ck, vals=cv, sc=sc, tables=tuple(blocks),
                base_excl=torch.from_numpy(base_excl).to(dev),
                nsid=torch.from_numpy(nsid).to(dev),
                kw=dict(kpb=kpb, r=r, a_max=a_max, n=n))


def _run_pass(fn, inp, lookahead, **extra):
    alt_k = torch.full_like(inp["keys"], -1)
    alt_v = tuple(torch.zeros_like(v) for v in inp["vals"])
    return fn(inp["keys"], inp["vals"], alt_k, alt_v, inp["sc"],
              *inp["tables"], inp["base_excl"], inp["nsid"],
              lookahead=lookahead, **inp["kw"], **extra)


def _assert_pass_bytes_equal(got, want, n):
    from repro_torch.kernels.ref import int_view
    assert torch.equal(got[0][:n], want[0][:n])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(int_view(a[:n]), int_view(b[:n]))
    assert len(got) == len(want)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key_bytes", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [1, 3, 5, 8, 9, 10, 12, 16])
def test_fused_kernel_widths_equal_plain(dev, key_bytes, d):
    """Key widths 1-8 bytes, digit widths, unaligned row starts (segments
    at odd offsets), gaps copied through, 8 value leaves of mixed widths,
    lookahead on and off."""
    from repro_torch.kernels import fused, ref
    if 8 * key_bytes < d:
        pytest.skip("digit wider than the key")
    rng = np.random.default_rng(key_bytes * 10 + d)
    n = 20011
    bounds = [(3, 5000), (5005, 1), (5007, 9001), (14011, 5997)]
    inp = _pass_inputs(dev, rng, n, key_bytes, d, 0, bounds, 6, 1152, 8)
    for lookahead in (False, True):
        want = _run_pass(ref.fused_counting_pass_ref, inp, lookahead)
        got = _run_pass(fused.fused_counting_pass, inp, lookahead)
        torch.cuda.synchronize()
        _assert_pass_bytes_equal(got, want, n)


@pytest.mark.parametrize("case", ["all_equal", "later_pass", "narrow_last",
                                  "one_region", "all_equal_wide_table"])
def test_fused_kernel_cases_equal_plain(dev, case):
    """All-equal keys (one digit run per row; a_max 2: the whole next-pass
    table in shared memory), the same with a_max 40 (long-run tables), a
    later pass (many short regions), the last pass narrower than d, and one
    region of many rows (a long look-back chain) at KPB 6912."""
    from repro_torch.kernels import fused, ref
    rng = np.random.default_rng(len(case))
    n = 1 << 18
    if case in ("all_equal", "all_equal_wide_table"):
        inp = _pass_inputs(dev, rng, n, 4, 8, 0, [(0, n)],
                           2 if case == "all_equal" else 40, 6912, 1,
                           all_equal=True)
    elif case == "later_pass":
        cuts = np.sort(rng.choice(np.arange(1, n), 300, replace=False))
        edges = np.concatenate([[0], cuts, [n]])
        bounds = [(int(a), int(b - a)) for a, b in zip(edges[:-1], edges[1:])
                  if b - a > 40][:200]
        inp = _pass_inputs(dev, rng, n, 4, 8, 1, bounds, 256, 6912, 2)
    elif case == "narrow_last":
        inp = _pass_inputs(dev, rng, n, 4, 7, 4, [(5, n - 9)], 3, 6912, 1)
    else:
        inp = _pass_inputs(dev, rng, n, 4, 8, 0, [(0, n)], 2, 640, 3)
    for lookahead in (False, True):
        want = _run_pass(ref.fused_counting_pass_ref, inp, lookahead)
        got = _run_pass(fused.fused_counting_pass, inp, lookahead)
        torch.cuda.synchronize()
        _assert_pass_bytes_equal(got, want, n)


def test_fused_kernel_64bit_lookback_words(dev):
    """One keys-only pass of 2^30 + 7 all-equal keys: a digit count passes
    2^30, so the look-back uses 64-bit words.  The plain version's int64
    temporaries for 2^30 keys do not fit the card; its result here is
    closed-form (checked against it at 2^20 + 7 below): every key lands in
    [0, n), the buffer past n is untouched, and the one next-digit bin of
    the segment counts n."""
    from repro_torch.kernels import fused, ref
    assert fused.lookback_word_bytes((1 << 30) + 7) == 8
    for n in ((1 << 20) + 7, (1 << 30) + 7):
        kpb = 6912
        key = 0x5A3C_F00D
        keys = torch.full((fused.pad_length(n, kpb),), key,
                          dtype=torch.int32, device=dev)
        keys[n:] = -1
        a_max, r = 2, 256
        blocks = _region(dev, n, kpb, a_max)
        base_excl = torch.zeros((a_max, r), dtype=torch.int32, device=dev)
        base_excl[0, (key >> 24) + 1:] = n
        base_excl[1] = n
        nsid = torch.full((a_max * r,), a_max, dtype=torch.int32, device=dev)
        nsid[key >> 24] = 0
        sc = (24, 8, 16, 8, 8, 8)
        alt = torch.full_like(keys, 7)
        got = fused.fused_counting_pass(
            keys, (), alt, (), sc, *blocks, base_excl, nsid, kpb=kpb, r=r,
            a_max=a_max, n=n, lookahead=True)
        torch.cuda.synchronize()
        want_hist = torch.zeros(a_max * r, dtype=torch.int32, device=dev)
        want_hist[(key >> 16) & 255] = n
        want_hist2 = torch.zeros_like(want_hist)
        want_hist2[(key >> 8) & 255] = n
        if n < 1 << 21:
            plain = ref.fused_counting_pass_ref(
                keys, (), torch.full_like(keys, 7), (), sc, *blocks,
                base_excl, nsid, kpb=kpb, r=r, a_max=a_max, n=n,
                lookahead=True)
            _assert_pass_bytes_equal(got, plain, n)
        assert bool((got[0][:n] == key).all())
        assert bool((got[0][n:] == 7).all())
        assert torch.equal(got[2], want_hist)
        assert torch.equal(got[3], want_hist2)
        del keys, alt, got
        torch.cuda.empty_cache()


def _region(dev, n, kpb, a_max):
    from repro_torch.core import plan
    base = torch.full((a_max,), n, dtype=torch.int32, device=dev)
    size = torch.zeros_like(base)
    base[0], size[0] = 0, n
    return tuple(plan.make_region_blocks(base, size, n, kpb,
                                         plan.max_region_blocks(n, kpb,
                                                                a_max)))


def test_fused_kernel_inert_rows_mid_table(dev):
    """Count-0 rows between regions are no-ops, however many: more of them
    than CTAs fit the card at once, before two region starts mid-table."""
    from repro_torch.kernels import fused, ref
    rng = np.random.default_rng(14)
    n = 1 << 18
    cuts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
    edges = np.concatenate([[0], cuts, [n]])
    bounds = [(int(a), int(b - a)) for a, b in zip(edges[:-1], edges[1:])
              if b - a > 2000]
    inp = _pass_inputs(dev, rng, n, 4, 8, 1, bounds, 64, 1152, 2)
    want = _run_pass(ref.fused_counting_pass_ref, inp, True)
    seg, off, reset, count, active = (t.cpu() for t in inp["tables"])
    starts = torch.nonzero((reset == 1) & (count > 0)).flatten().tolist()
    live = int((count > 0).sum())
    at = sorted({starts[len(starts) // 3], starts[2 * len(starts) // 3]})
    assert 0 < at[0] < live
    pieces = [[] for _ in range(5)]
    prev = 0
    for g, pad in zip(at, (1200, 300)):
        for piece, t, fill in zip(pieces, (seg, off, reset, count, active),
                                  (64, 0, 1, 0, 0)):
            piece += [t[prev:g], t.new_full((pad,), fill)]
        prev = g
    inp["tables"] = tuple(torch.cat(piece + [t[prev:]]).to(dev) for piece, t
                          in zip(pieces, (seg, off, reset, count, active)))
    got = _run_pass(fused.fused_counting_pass, inp, True)
    torch.cuda.synchronize()
    _assert_pass_bytes_equal(got, want, n)


@pytest.mark.parametrize("key_bytes", [4, 8])
def test_fused_kernel_512_digits_at_table3_kpb(dev, key_bytes):
    """r = 512 at KPB 6912 with leaves up to 8 bytes (the widest shared
    layout, about 210 KB with 8-byte keys), one region and many regions,
    unaligned rows included."""
    from repro_torch.kernels import fused, ref
    rng = np.random.default_rng(512 + key_bytes)
    n = 1 << 18
    cuts = np.sort(rng.choice(np.arange(1, n), 120, replace=False))
    edges = np.concatenate([[3], cuts, [n]])
    many = [(int(a), int(b - a)) for a, b in zip(edges[:-1], edges[1:])
            if b - a > 40][:100]
    for pass_idx, bounds, a_max in ((0, [(0, n)], 2), (1, many, 128)):
        inp = _pass_inputs(dev, rng, n, key_bytes, 9, pass_idx, bounds,
                           a_max, 6912, 4)
        for lookahead in (False, True):
            want = _run_pass(ref.fused_counting_pass_ref, inp, lookahead)
            got = _run_pass(fused.fused_counting_pass, inp, lookahead)
            torch.cuda.synchronize()
            _assert_pass_bytes_equal(got, want, n)


def _skewed_keys(rng, n, d, kpb):
    """uint32 keys whose pass-0 digits (the top d bits) are mostly four
    common digits, with rare digits at fixed periods of rows: digit 7 once
    every 50 rows, digit 9 once every 120, digit r - 1 in rows 0 and 300
    only, so their walks reach far back (for digit r - 1 past the 256 rows
    a row confirms at once)."""
    r = 1 << d
    dig = rng.choice(np.array([1, 2, r // 2, r - 2], np.uint32), n)
    dig[::50 * kpb] = 7
    dig[37::120 * kpb] = 9
    dig[[11, 300 * kpb + 5]] = r - 1
    low = rng.integers(0, 2**(32 - d), n, dtype=np.uint32)
    return (dig << np.uint32(32 - d)) | low


@pytest.mark.parametrize("d", [12, 16])
@pytest.mark.parametrize("case", ["all_equal", "later_pass", "last_pass",
                                  "one_region", "long_region", "skewed",
                                  "unaligned_regions"])
def test_fused_wide_kernel_cases_equal_plain(dev, d, case):
    """The wide variant (r > 512): all-equal keys (one run per row, one
    next-pass atomic per warp step), a later pass (many short regions), the
    last pass (at d = 12 8 bits wide: one counting round), one region of 38
    rows of 8-byte keys at KPB 6912 starting off a 16-byte boundary, one
    region of 310 rows (the look-back across many rows in flight), a
    skewed region of 304 rows whose rare digits make the walks deep, and
    regions whose first rows start off a 16-byte boundary, with value
    leaves."""
    from repro_torch.kernels import fused, ref
    rng = np.random.default_rng(d + len(case))
    n = 1 << 18
    if case == "all_equal":
        inp = _pass_inputs(dev, rng, n, 4, d, 0, [(0, n)], 2, 6912, 1,
                           all_equal=True)
    elif case == "later_pass":
        cuts = np.sort(rng.choice(np.arange(1, n), 300, replace=False))
        edges = np.concatenate([[0], cuts, [n]])
        bounds = [(int(a), int(b - a)) for a, b in zip(edges[:-1], edges[1:])
                  if b - a > 40][:200]
        inp = _pass_inputs(dev, rng, n, 4, d, 1, bounds, 256, 6912, 2)
    elif case == "last_pass":
        inp = _pass_inputs(dev, rng, n, 4, d, 31 // d, [(5, n - 9)], 3,
                           6912, 1)
    elif case == "one_region":
        inp = _pass_inputs(dev, rng, n, 8, d, 0, [(3, n - 3)], 2, 6912, 3)
    elif case == "long_region":
        n = 310 * 6912 - 5
        inp = _pass_inputs(dev, rng, n, 4, d, 0, [(0, n)], 2, 6912, 2)
    elif case == "skewed":
        n = 304 * 6912
        inp = _pass_inputs(dev, rng, n, 4, d, 0, [(0, n)], 2, 6912, 2,
                           x=_skewed_keys(rng, n, d, 6912))
    else:
        n = 1 << 20
        bounds = [(1, 70001), (70003, 300001), (370005, 200000),
                  (570006, n - 570006)]
        inp = _pass_inputs(dev, rng, n, 4, d, 1, bounds, 8, 6912, 2)
        off = inp["tables"][1].cpu()
        reset = inp["tables"][2].cpu()
        active = inp["tables"][4].cpu()
        firsts = off[(reset == 1) & (active == 1)]
        assert bool((firsts % 4 != 0).all()) and firsts.numel() == 4
    for lookahead in (False, True):
        want = _run_pass(ref.fused_counting_pass_ref, inp, lookahead)
        got = _run_pass(fused.fused_counting_pass, inp, lookahead)
        torch.cuda.synchronize()
        _assert_pass_bytes_equal(got, want, n)


def _r3_edge_rows(rng, r, lt, mt):
    """(7, r) sub-bucket size rows of R3's edge cases: all zeros, zero runs
    across 32-digit steps, sizes equal to local_threshold (and one above),
    sizes that take acc exactly to merge_threshold at steps' edges, big
    sizes near 2^31 - 1, many small sizes, and sizes that each start a
    group."""
    rows = np.zeros((7, r), np.int64)
    rows[1] = rng.integers(1, mt, r)
    for a, b in ((20, 100), (250, 300), (511, 1100), (r - 40, r)):
        rows[1, a:b] = 0
    rows[2] = rng.integers(0, 3, r)
    rows[2, rng.choice(r, r // 8, replace=False)] = lt
    rows[2, rng.choice(r, r // 16, replace=False)] = lt + 1
    for at in range(0, r - 3, 31):
        a = int(rng.integers(1, mt))
        rows[3, at:at + 2] = a, mt - a
        rows[3, at + 2:at + 4] = (mt - a - 1, 1) if a + 1 < mt else (0, 1)
    rows[4] = rng.integers(0, 4, r)
    rows[4, rng.choice(r, r // 4, replace=False)] = 2**31 - 1 - rng.integers(
        0, 3, r // 4)
    rows[4, 64:70] = 2**31 - 1
    rows[5] = rng.integers(0, 3, r)
    rows[6] = rng.integers(mt, max(mt, lt) + 1, r)
    return rows.astype(np.int32)


@pytest.mark.parametrize("r", [256, 4096, 65536])
def test_merge_rows_kernel_equals_plain(dev, r):
    """R3 on the card against its plain version: the edge rows alone, one
    row (one warp), and the edge rows among far more random rows than the
    card runs warps at once, at two threshold pairs."""
    from repro_torch.core import plan
    from repro_torch.kernels import ref
    rng = np.random.default_rng(r)
    many = max(64, (1 << 25) // r)
    for lt, mt in ((9216, 3000), (48, 32)):
        edge = _r3_edge_rows(rng, r, lt, mt)
        rand = rng.integers(0, 2 * mt, (many, r)).astype(np.int32)
        rand[rng.random((many, r)) < 0.5] = 0
        rand[::7] = edge[rng.integers(0, len(edge), len(rand[::7]))]
        for hist in (edge, edge[4:5], rand):
            h = torch.from_numpy(hist).to(dev)
            got = plan.merge_rows(h, lt, mt)
            want = ref.merge_rows_ref(h, lt, mt)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def test_fused_kernel_refuses_rows_over_shared_memory(dev):
    """A KPB whose row does not fit one CTA's shared memory raises."""
    from repro_torch.kernels import fused
    keys = torch.zeros(2 * 65536, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="fused_pass"):
        _run_pass(fused.fused_counting_pass, dict(
            keys=keys, vals=(), sc=(0, 8, 0, 0), tables=_region(
                dev, 65536, 65536, 2),
            base_excl=torch.zeros((2, 256), dtype=torch.int32, device=dev),
            nsid=torch.zeros(512, dtype=torch.int32, device=dev),
            kw=dict(kpb=65536, r=256, a_max=2, n=65536)), False)


# ---- the redesigned local sort (per-bucket radix sort over the live bits,
# value leaves moved in the kernel) ----------------------------------------

_LEAF_DTYPES = (torch.int8, torch.int16, torch.float32, torch.int64,
                torch.bool, torch.float64, torch.int32, torch.uint8)


def _bucket_keys(rng, kind, size, key_bytes):
    """One bucket's unsigned keys: random, or an edge case."""
    u = _KEY_DTYPES[key_bytes]
    top = u(1) << u(8 * key_bytes - 1)
    ones = np.iinfo(u).max
    if kind == "random":
        return rng.integers(0, ones, size, dtype=u, endpoint=True)
    if kind == "ties":
        return rng.integers(0, 5, size, dtype=u)
    if kind == "all_equal":
        return np.full(size, ones // 3, u)
    if kind == "bit0":
        return (u(ones // 5) & ~u(1)) | rng.integers(0, 2, size, dtype=u)
    if kind == "top_bit":
        return np.where(rng.random(size) < 0.5, top, u(0)) | u(3)
    x = rng.integers(0, 40, size, dtype=u)               # all-ones keys
    x[rng.random(size) < 0.2] = ones
    return x


def _segments_case(dev, length, key_bytes, seed):
    """A key buffer whose buckets of one class sit at unaligned starts
    between unflagged gaps, the class's (starts, sizes) rows (a size-0 row
    mid-table and the trailing ones the planner leaves), and 8 mixed
    leaves."""
    rng = np.random.default_rng(seed)
    low = 1 if length <= 32 else length // 2 + 1
    kinds = ["random", "ties", "all_equal", "bit0", "top_bit", "ones"]
    sizes = [int(rng.integers(low, length + 1)) for _ in kinds]
    sizes += [length, low, 1, int(rng.integers(low, length + 1))]
    kinds += ["random", "ones", "random", "ties"]
    parts, starts, at = [], [], 0
    for kind, size in zip(kinds, sizes):
        gap = int(rng.integers(1, 40))
        parts.append(_bucket_keys(rng, "random", gap, key_bytes))
        at += gap
        starts.append(at)
        parts.append(_bucket_keys(rng, kind, size, key_bytes))
        at += size
    keys = _carrier(np.concatenate(parts)).to(dev)
    starts.insert(3, 0)
    sizes.insert(3, 0)
    starts += [0] * 5
    sizes += [0] * 5
    leaves = tuple(torch.from_numpy(rng.integers(-2**62, 2**62, keys.numel()))
                   .to(dt).to(dev) for dt in _LEAF_DTYPES)
    table = [torch.tensor(t, dtype=torch.int32, device=dev)
             for t in (starts, sizes)]
    return keys, leaves, table


def _run_segments(fn, keys, leaves, table, length, perm):
    k = keys.clone()
    v = tuple(x.clone() for x in leaves)
    p = (torch.arange(k.numel(), dtype=torch.int32, device=k.device)
         if perm else None)
    fn(k, p, *table, length, v)
    return [k, *v] + ([p] if perm else [])


@pytest.mark.parametrize("length", [32 << i for i in range(10)])
@pytest.mark.parametrize("key_bytes", [1, 2, 4, 8])
@pytest.mark.parametrize("perm", [False, True], ids=["leaves", "perm"])
def test_local_sort_kernel_equals_plain(dev, length, key_bytes, perm):
    from repro_torch.kernels import COUNTS, bitonic, ref, reset_counts
    keys, leaves, table = _segments_case(dev, length, key_bytes,
                                         length + key_bytes)
    reset_counts()
    got = _run_segments(bitonic.sort_segments_stable, keys, leaves, table,
                        length, perm)
    torch.cuda.synchronize()
    assert COUNTS["local_sort"] == 1
    want = _run_segments(ref.sort_segments_ref, keys, leaves, table, length,
                         perm)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("length", [32, 8192])
def test_local_sort_kernel_empty_class_changes_nothing(dev, length):
    from repro_torch.kernels import COUNTS, bitonic, reset_counts
    keys, leaves, _ = _segments_case(dev, length, 4, 3)
    zeros = torch.zeros(200000, dtype=torch.int32, device=dev)
    reset_counts()
    got = _run_segments(bitonic.sort_segments_stable, keys, leaves,
                        (zeros, zeros), length, True)
    torch.cuda.synchronize()
    assert COUNTS["local_sort"] == 1
    assert _bits_equal(got[0], keys)
    assert all(_bits_equal(a, b) for a, b in zip(got[1:-1], leaves))
    assert torch.equal(got[-1], torch.arange(keys.numel(), dtype=torch.int32,
                                             device=dev))


def test_local_sort_kernel_refuses_a_class_over_shared_memory(dev):
    from repro_torch.kernels import bitonic
    keys = torch.zeros(1 << 15, dtype=torch.int64, device=dev)
    table = [torch.tensor([0], dtype=torch.int32, device=dev),
             torch.tensor([1 << 15], dtype=torch.int32, device=dev)]
    with pytest.raises(RuntimeError, match="local_sort"):
        bitonic.sort_segments_stable(keys, None, *table, 1 << 15)


def test_hybrid_sort_main_path_moves_leaves_in_the_kernel(dev):
    """2^28 uint32 keys with two value leaves: the sort equals
    torch.sort(stable=True) and its indices, and the finish runs the
    local-sort kernel."""
    from repro_torch import hybrid_sort
    from repro_torch.core import bijection
    from repro_torch.kernels import COUNTS, reset_counts
    n = 1 << 28
    gen = torch.Generator(device=dev).manual_seed(28)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    reset_counts()
    out_k, (out_i, out_w) = hybrid_sort(keys.view(torch.uint32),
                                        (idx, idx.to(torch.int64) * 3))
    torch.cuda.synchronize()
    assert COUNTS["local_sort"] >= 1
    want = torch.sort(bijection.sortable(keys), stable=True)
    assert torch.equal(bijection.sortable(out_k.view(torch.int32)),
                       want.values)
    assert torch.equal(out_i.to(torch.int64), want.indices)
    assert torch.equal(out_w, want.indices * 3)


@pytest.mark.parametrize("ands", [0, 3])
def test_hybrid_sort_holds_under_2_4x_its_input(dev, ands):
    """A kernel-engine hybrid_sort of 2^24 uint32 pairs holds less than 2.4x
    its input's bytes above what was held before it: the ping-pong buffers
    (2x) and the plan's tables, which keep no per-key bucket state."""
    from repro_torch import hybrid_sort
    n = 1 << 24
    gen = torch.Generator(device=dev).manual_seed(24 + ands)

    def words():
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)
    keys = words()
    for _ in range(ands):
        keys &= words()
    keys, vals = keys.view(torch.uint32), words().view(torch.uint32)
    hybrid_sort(keys, vals)                       # builds, warms the cache
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = hybrid_sort(keys, vals)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated(dev) - before
    assert out[0].shape == (n,)
    assert held < 2.4 * 8 * n, held / (8 * n)


# ---- the assigned histogram, redesigned (prologue tables, count_range) ----

@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.uint16,
                                   torch.int16, torch.uint32, torch.int32,
                                   torch.uint64, torch.int64], ids=str)
@pytest.mark.parametrize("kpb", [1, 7, 1030, 6911])
def test_assigned_kernel_every_width_and_key_size(dev, dtype, kpb):
    """Widths 1..16 on 1-, 2-, 4- and 8-byte signed and unsigned keys (a
    shift inside the key and one past its top bit: logical against
    arithmetic), valid 0 / 1 / 3 / -1, negative and out-of-range tile
    indices, tiles that start off a 16-byte boundary and one-key tiles,
    against the plain version, exactly."""
    from repro_torch.kernels import assigned, ref
    rng = np.random.default_rng(kpb)
    tiles = 40
    keys = _rows_input(rng, (tiles, kpb), dtype).to(dev)
    keys[3] = keys[3, :1]                        # one all-equal tile
    idx = np.concatenate([rng.permutation(tiles), rng.permutation(tiles),
                          [-1, -tiles, -tiles - 1, tiles, 2**31 - 1,
                           -2**31, 5]])
    tile_idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.choice(
        np.array([0, 1, 3, -1], np.int32), idx.size)).to(dev)
    bits = 8 * keys.element_size()
    for width in range(1, 17):
        for shift in (max(0, bits - width - 1), bits - 2):
            got = assigned.assigned_histogram(keys, tile_idx, valid, shift,
                                              width)
            want = ref.assigned_histogram_ref(keys, tile_idx, valid, shift,
                                              width)
            assert torch.equal(got, want), (width, shift)


def test_assigned_kernel_many_slots(dev):
    """200 000 slots over 3 000 short tiles, random valid and tile indices,
    against the plain version."""
    from repro_torch.kernels import assigned, ref
    rng = np.random.default_rng(19)
    keys = torch.from_numpy(_keys(rng, 3000 * 256)).to(dev).view(
        torch.uint32).reshape(3000, 256)
    slots = 200000
    tile_idx = torch.from_numpy(rng.integers(-3000, 3000, slots)
                                .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.integers(-1, 3, slots).astype(np.int32)
                             ).to(dev)
    for width in (1, 4, 8, 9):
        assert torch.equal(
            assigned.assigned_histogram(keys, tile_idx, valid, 20, width),
            ref.assigned_histogram_ref(keys, tile_idx, valid, 20, width))


# ---- slice S2: the LSD sort and the single-pass partition on the card ----

def _census():
    from repro_torch.kernels import COUNTS
    torch.cuda.synchronize()
    return COUNTS["histogram"], COUNTS["fused_pass"]


@pytest.mark.parametrize("d", [4, 5, 8, 9, 12])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int64])
def test_lsd_sort_on_card_equals_torch_sort(dev, d, dtype):
    """At the reference's kpb (1024) and the hybrid sort's (6912)."""
    from repro_torch import lsd_sort
    from repro_torch.core import bijection
    from repro_torch.kernels import reset_counts
    rng = np.random.default_rng(d)
    n = 300001
    bits = rng.integers(0, 2**63, n, dtype=np.uint64)
    x = bits.astype(np.uint32).view(dtype) if dtype != np.int64 else \
        bits.view(np.int64)
    keys = torch.from_numpy(x).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    carrier = bijection.sortable(bijection.to_ordered_bits(keys))
    want = torch.sort(carrier, stable=True)
    cpu = lsd_sort(x, np.arange(n, dtype=np.int32), d=d, engine="argsort",
                   device="cpu")
    for kpb in (1024, 6912):
        reset_counts()
        out_k, out_v, passes = lsd_sort(keys, vals, d=d, kpb=kpb,
                                        return_passes=True)
        assert _census() == (1, passes)
        got = bijection.sortable(bijection.to_ordered_bits(out_k))
        assert torch.equal(got, want.values)
        assert torch.equal(out_v.to(torch.int64), want.indices)
        assert _bits_equal(out_k.cpu(), cpu[0]) and torch.equal(
            out_v.cpu(), cpu[1])


def test_lsd_sort_on_card_edge_cases(dev):
    """All-equal keys (no pass, one prologue launch), duplicates, a narrow
    live window, 8-bit keys and the leaf limit (no fallback)."""
    from repro_torch import lsd_sort
    from repro_torch.kernels import reset_counts
    rng = np.random.default_rng(5)
    for x, d in ((np.full(5000, 9, np.uint32), 5),
                 (rng.integers(0, 6, 70000).astype(np.uint32), 5),
                 (rng.integers(0, 2**32, 70000, dtype=np.uint32) &
                  np.uint32(0x0FF0F000), 4),
                 (rng.integers(0, 256, 70000).astype(np.uint8), 8)):
        reset_counts()
        got_k, got_v, passes = lsd_sort(x, np.arange(x.size), d=d,
                                        return_passes=True)
        assert _census() == (1, passes)
        order = np.argsort(x, kind="stable")
        assert np.array_equal(got_k.cpu().numpy(), x[order])
        assert np.array_equal(got_v.cpu().numpy(), order)
    leaves = tuple(torch.zeros(100, dtype=torch.int32, device=dev)
                   for _ in range(9))
    with pytest.raises(ValueError, match="value leaves"):
        lsd_sort(torch.arange(100, device=dev), leaves)


@pytest.mark.parametrize("num_buckets", [1, 2, 255, 256, 384, 512, 513,
                                         4096, 65536])
def test_counting_partition_on_card_equals_torch_sort(dev, num_buckets):
    """``counting_partition`` (kpb 1024), then the single pass at the
    hybrid sort's kpb 6912."""
    from repro_torch.core import plan, segmented
    from repro_torch.kernels import reset_counts
    rng = np.random.default_rng(num_buckets)
    m = 500003
    ids = rng.integers(0, num_buckets, m).astype(np.int32)
    ids[::5] = num_buckets - 1                   # the sentinel's digit
    t = torch.from_numpy(ids).to(dev)
    reset_counts()
    part = segmented.counting_partition(t, num_buckets)
    assert _census() == (1, 1)
    want = torch.sort(t, stable=True).indices
    assert torch.equal(part.perm.to(torch.int64), want)
    assert torch.equal(part.dest[part.perm.long()],
                       torch.arange(m, dtype=torch.int32, device=dev))
    assert torch.equal(part.counts, torch.bincount(
        t, minlength=num_buckets).to(torch.int32))
    cpu = segmented.counting_partition(torch.from_numpy(ids), num_buckets,
                                       engine="argsort")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(part, cpu))
    reset_counts()
    dest, perm, counts = plan.single_pass_partition(t, num_buckets, kpb=6912)
    assert _census() == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(
        (dest, perm, counts), (part.dest, part.perm, part.counts)))


def test_capacity_dispatch_on_card_equals_cpu(dev):
    from repro_torch.core import segmented
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.3, 1 << 16).clip(1, 384) - 1).astype(np.int32)
    got = segmented.capacity_dispatch(torch.from_numpy(ids).to(dev), 384,
                                      200)
    want = segmented.capacity_dispatch(torch.from_numpy(ids), 384, 200,
                                       engine="argsort")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# ---- slice S4: the distributed sort; length bucketing ----

def _dist_keys(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5]
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _dist_equal(got, want):
    """Keys, values and stats of two distributed sorts, byte for byte."""
    for a, b in zip(got[:-1], want[:-1]):
        assert _bits_equal(a.cpu(), b.cpu())
    for f in got[-1]._fields:
        assert torch.equal(getattr(got[-1], f).cpu(),
                           getattr(want[-1], f).cpu())


@pytest.mark.parametrize("values", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint32,
                                   np.float32, np.int64, np.float64])
@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_distributed_sort_on_card_equals_cpu(dev, nshards, dtype, values):
    """``LocalMesh(P)`` on the card against ``LocalMesh(P, "cpu")``: the
    padded keys, the values and every stats field; the census is C·(1 + A)
    + 1 histograms a shard."""
    from repro_torch.core.distributed import LocalMesh, make_distributed_sort
    from repro_torch.kernels import COUNTS, reset_counts
    rng = np.random.default_rng(nshards)
    n = nshards * 40000
    x = _dist_keys(rng, dtype, n)
    args = (x, np.arange(n, dtype=np.int32)) if values else (x,)
    for chunks in (1, 2):
        reset_counts()
        got = make_distributed_sort(LocalMesh(nshards),
                                    num_chunks=chunks)(*args)
        torch.cuda.synchronize()
        attempts = int(got[-1].exchange_attempts[0])
        assert COUNTS["histogram"] == nshards * (chunks * (1 + attempts) + 1)
        assert COUNTS["fused_pass"] >= nshards * (chunks * attempts + 1)
        assert got[0].device.type == "cuda"
        want = make_distributed_sort(LocalMesh(nshards, "cpu"),
                                     num_chunks=chunks,
                                     engine="argsort")(*args)
        _dist_equal(got, want)


def test_distributed_sort_on_card_retry_and_edges(dev):
    """The adversarial retry input (converges at slack 1.2, exhausts at
    0.5), the constant key and num_chunks > n_local, at P = 8."""
    from repro_torch.core.distributed import LocalMesh, make_distributed_sort
    rng = np.random.default_rng(7)
    n = 8 * (1 << 12)
    base = rng.integers(0, 2**32 - 1, n, dtype=np.uint32, endpoint=True)
    cl = (0x80000000 + rng.integers(0, 1 << 16, n, dtype=np.uint32))
    x = np.where(rng.random(n) < 0.95, cl, base).astype(np.uint32)
    cases = [(x, dict(oversample=2, slack=1.2)),
             (x, dict(oversample=2, slack=0.5)),
             (np.full(n, 42, np.uint32), {}),
             (x[:8], dict(num_chunks=4))]
    for keys, knobs in cases:
        got = make_distributed_sort(LocalMesh(8), **knobs)(keys)
        want = make_distributed_sort(LocalMesh(8, "cpu"), engine="argsort",
                                     **knobs)(keys)
        _dist_equal(got, want)
    st = make_distributed_sort(LocalMesh(8), oversample=2, slack=1.2)(x)[1]
    assert int(st.exchange_attempts[0]) > 1 and not st.overflow.any()


def test_nccl_world_one_mesh_equals_local_mesh(dev, tmp_path):
    """A one-rank NCCL group: the process-group mesh's bytes and stats
    equal ``LocalMesh(1)``'s."""
    import torch.distributed as dist
    from repro_torch.core.distributed import (LocalMesh, ProcessGroupMesh,
                                              make_distributed_sort)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = ProcessGroupMesh()
        assert mesh.device == dev and mesh.shards == (0,)
        rng = np.random.default_rng(11)
        x = rng.integers(0, 2**32, 1 << 20, dtype=np.uint32)
        v = np.arange(x.size, dtype=np.int32)
        for chunks in (1, 4):
            got = make_distributed_sort(mesh, num_chunks=chunks)(x, v)
            want = make_distributed_sort(LocalMesh(1),
                                         num_chunks=chunks)(x, v)
            _dist_equal(got, want)
    finally:
        dist.destroy_process_group()


def test_length_bucketing_on_card_equals_cpu(dev):
    from repro_torch.core.distributed import LocalMesh
    from repro_torch.data import length_bucketed_batches
    rng = np.random.default_rng(13)
    x = rng.integers(0, 1 << 16, 100003).astype(np.uint32)
    want = length_bucketed_batches(x, 1 << 16, device="cpu")
    routes = [dict(), dict(ooc_chunk_elems=1 << 14),
              dict(dist_mesh=LocalMesh(4)), dict(dist_mesh=LocalMesh(1))]
    for kw in routes:
        order, bounds = length_bucketed_batches(x, 1 << 16, **kw)
        assert np.array_equal(x[order], x[want[0]]) and bounds == want[1]
        assert np.array_equal(np.sort(order), np.arange(x.size))
    order, _ = length_bucketed_batches(x, 1 << 16)
    assert np.array_equal(order, want[0])           # the host route: stable


# --------------------------------------------------------------------------
# the serving path: the model zoo, the MoE dispatch and ServeEngine
# --------------------------------------------------------------------------

#: the port on the card against the port on the CPU on the same float32
#: parameters (matmuls without TF32, torch's default): the two sum in
#: different orders, so logits and caches agree to rounding, not bits
SERVE_ATOL = 1e-4


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _near(got, want, what):
    err = float((got.cpu() - want).abs().max())
    assert err <= SERVE_ATOL, (what, err)


def _cache_near(got, want):
    for name in ("kv_k", "kv_v", "ssm_state", "ssm_conv"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            for i, (a, b) in enumerate(zip(g, w)):
                _near(a, b, f"{name}[{i}]")
    assert got.length == want.length


@pytest.mark.parametrize("arch", [
    "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "musicgen_medium",
    "internlm2_1_8b", "deepseek_67b", "phi4_mini_3_8b", "deepseek_7b",
    "hymba_1_5b", "mamba2_1_3b", "internvl2_26b"])
def test_models_on_card_equal_cpu(dev, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    gpu = _to(cpu, dev)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    gbatch = _to(batch, dev)
    want, want_aux = forward(cpu, cfg, batch)
    got, got_aux = forward(gpu, cfg, gbatch)
    assert got.device.type == "cuda"
    _near(got, want, "forward")
    _near(got_aux, want_aux, "aux")
    pre = lambda b: dict(b, tokens=b["tokens"][:, :8])  # noqa: E731
    lw, cw = prefill(cpu, cfg, pre(batch), max_len=14)
    lg, cg = prefill(gpu, cfg, pre(gbatch), max_len=14)
    _near(lg, lw, "prefill")
    _cache_near(cg, cw)
    for t in range(8, 12):
        lw, cw = decode_step(cpu, cfg, batch["tokens"][:, t:t + 1], cw)
        lg, cg = decode_step(gpu, cfg, gbatch["tokens"][:, t:t + 1], cg)
        _near(lg, lw, f"decode {t}")
    _cache_near(cg, cw)


@pytest.mark.parametrize("experts,top_k,tokens,groups,cf", [
    (8, 2, 32, 1, 1.25), (8, 2, 32, 4, 0.1), (128, 8, 8, 1, 1.25),
    (128, 8, 384, 1, 1.25), (128, 8, 1024, 4, 16.0), (384, 8, 4096, 4, 1.25)])
def test_moe_dispatch_tables_on_card_equal_cpu(dev, experts, top_k, tokens,
                                               groups, cf):
    """The kernels' tables on the card byte-equal the CPU's argsort ones;
    two launches a group, no host read.  (128, 8, 8): a decode step of
    Qwen3-30B-A3B at batch 8."""
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import moe
    rng = np.random.default_rng(experts + tokens)
    probs = rng.random((tokens, experts)).astype(np.float32)
    ids = np.argsort(-probs, axis=1, kind="stable")[:, :top_k].astype(
        np.int32)
    tg = tokens // groups
    cap = min(max(4, int(cf * tg * top_k / experts)), tg * top_k)
    flat = torch.from_numpy(ids.reshape(groups, tg * top_k))
    want = moe._dispatch_tables(flat, experts, cap)
    torch.cuda.synchronize()
    reset_counts()
    got = moe._dispatch_tables(flat.to(dev), experts, cap)
    counts = dict(COUNTS)
    assert counts["histogram"] == groups and counts["fused_pass"] == groups
    assert counts["host_reads"] == 0
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


def test_serve_engine_on_card_equals_cpu(dev):
    """The smoke Qwen3 served on the card gives the CPU's batches and
    tokens; each decode step launches one histogram and one fused pass per
    layer and reads nothing back."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    cpu = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(6)
    spec = [(rng.integers(0, cfg.vocab, int(rng.integers(3, 12))).astype(
        np.int32), int(rng.integers(4, 200))) for _ in range(7)]
    queues = [[Request(i, p, m) for i, (p, m) in enumerate(spec)]
              for _ in range(2)]
    e_cpu = ServeEngine(cfg, cpu, 3, 256, device="cpu")
    e_gpu = ServeEngine(cfg, _to(cpu, dev), 3, 256)
    assert e_gpu.device.type == "cuda"
    b_cpu, b_gpu = e_cpu.schedule(queues[0]), e_gpu.schedule(queues[1])
    assert [[r.rid for r in b] for b in b_cpu] == \
        [[r.rid for r in b] for b in b_gpu]
    for bc, bg in zip(b_cpu, b_gpu):
        e_cpu.generate(bc)
        torch.cuda.synchronize()
        reset_counts()
        e_gpu.generate(bg)
        counts = dict(COUNTS)
        steps = (max(len(r.prompt) for r in bg)
                 + max(r.max_new_tokens for r in bg))
        assert counts["histogram"] == counts["fused_pass"] == \
            steps * cfg.n_layers
        assert counts["host_reads"] == 0
        for rc, rg in zip(bc, bg):
            assert np.array_equal(rc.generated, rg.generated), rc.rid


# --------------------------------------------------------------------------
# the training path: the backward, the optimizers, the token stream and
# the checkpoints
# --------------------------------------------------------------------------

#: a train step on the card against the same step on the CPU (float32,
#: no TF32): loss and gradient norm to rounding; an updated parameter
#: within TRAIN_ATOL, except where the two devices' rounding flips the sign
#: of a near-zero gradient, which moves AdamW's first step by up to 2·lr
TRAIN_ATOL = 1e-5


def _train_case(cfg, dev, engine=None, steps=2, microbatches=2):
    """``steps`` AdamW steps (warmup 0) of the smoke model on ``dev``: the
    per-step metrics and the final parameters, from the CPU's parameters
    drawn with seed 3."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.train import TrainState, make_train_step
    params = _to(init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu"), dev)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=4,
                           seed=1, num_patches=cfg.num_patches
                           if cfg.frontend == "vision_patches" else 0,
                           d_model=cfg.d_model, device=str(dev))
    opt, step = make_train_step(cfg, "adamw", warmup=0,
                                microbatches=microbatches, engine=engine)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    metrics = []
    for s in range(steps):
        state, m = step(state, data.batch(s))
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("arch", [
    "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "musicgen_medium",
    "internlm2_1_8b", "deepseek_67b", "phi4_mini_3_8b", "deepseek_7b",
    "hymba_1_5b", "mamba2_1_3b", "internvl2_26b"])
def test_train_step_on_card_equals_cpu(dev, arch):
    """Two train steps of every smoke config (remat on, 2 microbatches) on
    the card against the CPU; MoE configs launch one histogram and one
    fused pass per layer and microbatch in the forward and again in the
    recompute, and no step reads back."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.interop import tree_flatten
    from repro_torch.kernels import COUNTS, reset_counts
    cfg = get_smoke_config(arch)
    want, wm = _train_case(cfg, torch.device("cpu"))
    torch.cuda.synchronize()
    reset_counts()
    got, gm = _train_case(cfg, dev)
    counts = dict(COUNTS)
    per = 2 * cfg.n_layers * 2 * 2 if cfg.is_moe else 0   # x remat x mb x steps
    assert counts["histogram"] == counts["fused_pass"] == per, counts
    assert counts["host_reads"] == 0
    for a, b in zip(gm, wm):
        for k in ("loss", "grad_norm", "ce", "aux"):
            assert abs(float(a[k]) - float(b[k])) <= TRAIN_ATOL * max(
                1.0, abs(float(b[k]))), (k, float(a[k]), float(b[k]))
        assert float(a["lr"]) == float(b["lr"])
    lr = float(wm[-1]["lr"])
    off = total = 0
    for a, b in zip(tree_flatten(got.params)[0], tree_flatten(want.params)[0]):
        assert a.device.type == "cuda"
        err = (a.cpu() - b).abs()
        assert float(err.max()) <= 4.4 * lr
        off += int((err > TRAIN_ATOL).sum())
        total += err.numel()
    assert off <= total // 1000, (off, total)


def test_train_step_dispatch_engines_on_card(dev):
    """On the card the kernels and argsort build equal dispatch tables, so
    the backward's gathers give bit-identical parameters after two steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.interop import tree_flatten
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    k, km = _train_case(cfg, dev, engine="kernel")
    a, am = _train_case(cfg, dev, engine="argsort")
    for x, y in zip(tree_flatten(k)[0], tree_flatten(a)[0]):
        assert torch.equal(x, y)
    assert all(torch.equal(x["loss"], y["loss"]) for x, y in zip(km, am))


def test_synthetic_data_on_card_equals_cpu(dev):
    """The token stream on the card: tokens byte-equal to the CPU's (both
    take a float64 power rounded to float32), patches within 1e-6
    (``erfinv`` on the two devices)."""
    from repro_torch.data import SyntheticLMData, pipeline
    kw = dict(vocab=151936, seq_len=4096, global_batch=8, seed=0,
              num_patches=4, d_model=64)
    cpu = SyntheticLMData(**kw, device="cpu")
    gpu = SyntheticLMData(**kw)
    for step in (0, 3):
        a, b = gpu.batch(step), cpu.batch(step)
        assert a["tokens"].device.type == "cuda"
        assert torch.equal(a["tokens"].cpu(), b["tokens"])
        assert float((a["patches"].cpu() - b["patches"]).abs().max()) <= 1e-6
    key = pipeline._split2(pipeline._fold_in(pipeline._prng_key(0), 0))[0]
    u_gpu = pipeline._uniform(key, (64, 4096), 1e-6, 1.0, dev)
    u_cpu = pipeline._uniform(key, (64, 4096), 1e-6, 1.0, "cpu")
    assert torch.equal(u_gpu.cpu(), u_cpu)


def test_checkpoint_round_trip_of_cuda_bf16(dev, tmp_path):
    """CUDA bfloat16 leaves restore bit for bit onto the card; the async
    writer snapshots them before an in-place update."""
    from repro_torch.checkpoint import (AsyncCheckpointer, restore_checkpoint,
                                        save_checkpoint)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((257, 33), generator=gen, device=dev).to(torch.bfloat16)
    w.view(torch.int16)[0, :2] = torch.tensor([0x7FC1, 1], dtype=torch.int16,
                                              device=dev)
    tree = {"w": w, "layers": [{"m": torch.randn(5, device=dev)}],
            "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    like = _to({"w": torch.zeros_like(w), "layers": [{"m": torch.zeros(5)}],
                "count": torch.zeros((), dtype=torch.int32)}, dev)
    save_checkpoint(str(tmp_path / "a"), 1, tree)
    back = restore_checkpoint(str(tmp_path / "a"), 1, like)
    assert back["w"].device.type == "cuda" and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(back["layers"][0]["m"], tree["layers"][0]["m"])
    old = w.clone()
    ck = AsyncCheckpointer(str(tmp_path / "b"))
    ck.save(2, tree)
    w.add_(1)
    ck.wait()
    back = restore_checkpoint(str(tmp_path / "b"), 2, like)
    assert torch.equal(back["w"].view(torch.int16), old.view(torch.int16))


def _mesh_smoke_step(cfg, dev, mesh=None):
    """One train step of a smoke config from a seed (lr > 0), plain or
    with DTensor state placed by the sharding rules on ``mesh``; returns
    (loss, grad norm, updated parameters) as plain tensors."""
    from repro_torch.configs import SHAPES
    from repro_torch.core.interop import tree_flatten
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState, make_train_step
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                         device=dev)
    state = TrainState(params, get_optimizer(cfg.optimizer).init(params),
                       torch.ones((), dtype=torch.int32, device=dev))
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": torch.from_numpy(tok.astype(np.int32)).to(dev)}
    _, step = make_train_step(cfg, microbatches=2)
    if mesh is None:
        new, m = step(state, batch)
    else:
        place = lambda t: shd.distribute(  # noqa: E731
            t, shd.param_shardings(t, cfg, mesh), mesh)
        state = TrainState(place(state.params), place(state.opt_state),
                           state.step)
        batch = shd.distribute(batch, shd.to_shardings(shd.batch_specs(
            cfg, mesh, SHAPES["train_4k"]), mesh), mesh)
        with M.use_mesh(mesh):
            new, m = step(state, batch)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    return (full(m["loss"]), full(m["grad_norm"]),
            [full(t) for t in tree_flatten(new.params)[0]])


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "internlm2_1_8b",
                                  "hymba_1_5b"])
def test_one_rank_nccl_mesh_step_on_card_is_bit_equal(dev, arch):
    """A smoke train step on a one-rank NCCL ``DeviceMesh`` (1, 1) with
    DTensor state: loss, gradient norm and every parameter bit-equal to
    the plain step on the card, with the same dispatch launches; and
    ``compressed_psum`` over the group bit-equal to the int8 round trip."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch import mesh as M
    from repro_torch.optim import (compressed_psum, int8_compress,
                                   int8_decompress)
    cfg = get_smoke_config(arch)
    torch.cuda.synchronize()
    reset_counts()
    want = _mesh_smoke_step(cfg, dev)
    plain_counts = dict(COUNTS)
    M.open_group(device_type="cuda")
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        reset_counts()
        got = _mesh_smoke_step(cfg, dev, mesh)
        assert dict(COUNTS) == plain_counts
        x = torch.randn(5000, device=dev)
        assert torch.equal(compressed_psum(x, (mesh, "model")),
                           int8_decompress(*int8_compress(x), x.shape))
    finally:
        M.close_group()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert a.device.type == "cuda" and torch.equal(a, b)


# --------------------------------------------------------------------------
# the contract layer (repro_torch.analysis) on the card
# --------------------------------------------------------------------------

CONTRACT_NAMES = ["hybrid_sort", "hybrid_sort_kv", "lsd_sort",
                  "single_pass_partition", "moe_dispatch",
                  "pipeline_bucketing", "ooc_chunk_sort", "ooc_merge_round",
                  "ooc_slab_sweep", "distributed_shard"]


@pytest.mark.parametrize("name", CONTRACT_NAMES)
def test_contract_holds_with_the_cuda_kernels(dev, name):
    """Census (and the recorder against torch.profiler), sort-free, in
    place, sweep / link bytes and the write replay, on the card."""
    from repro_torch.analysis import contracts
    rep = contracts.run_contract(contracts.REGISTRY[name], dev)
    assert rep.ok, rep.findings
    assert not any(r for r in rep.checks.values())


def test_descriptor_tables_hold_on_the_card(dev):
    from repro_torch.analysis import contracts
    checks = contracts.table_checks(dev)
    assert checks and not any(checks.values()), checks


@pytest.mark.parametrize("with_values", [False, True])
def test_recorder_equals_the_profiler_on_the_main_path(dev, with_values):
    """A 2^22-key hybrid_sort at Table 3's config: the recorder's launches
    kernel by kernel equal torch.profiler's and the launch counters, no
    sort op, the declared census, in-place alternates and sweep bytes."""
    from repro_torch import hybrid_sort
    from repro_torch.analysis import contracts
    from repro_torch.analysis.trace import recording
    from repro_torch.core import hybrid, model
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.utils.census import (SortCounter, grouped,
                                          profiler_kernel_counts)
    n = 1 << 22
    keys = torch.from_numpy(_keys(np.random.default_rng(22), n)).to(dev)
    vals = (torch.arange(n, dtype=torch.int32, device=dev)
            if with_values else None)
    cfg = model.default_config(4)
    reset_counts()
    with recording() as rec, SortCounter() as sorts:
        out, profiled, _ = profiler_kernel_counts(
            lambda: hybrid_sort(keys, vals, cfg=cfg, return_stats=True))
    st = out[-1]
    assert grouped(rec.counts()) == profiled
    assert rec.counts()["_fused_pass_kernel"] == COUNTS["fused_pass"] == \
        st.counting_passes
    assert rec.counts()["_bitonic_stable_kernel"] == COUNTS["local_sort"]
    params = dict(contracts.hybrid_params(
        n, cfg, vals=int(with_values), val_bytes=4 * int(with_values)),
        passes=st.counting_passes, executed=st.counting_passes,
        elided=st.elided_passes)
    rep = contracts.check_run("main_path", hybrid.ANALYSIS_CONTRACT, rec,
                              sorts, params, device="cuda",
                              profiled=profiled)
    assert rep.ok, rep.findings
    assert not any(r.plain for r in rec.records)


def test_analysis_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("PASS") == 12


def test_fault_matrix_on_the_card(dev):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_fault_matrix.py"
    spec = importlib.util.spec_from_file_location("torch_fault_matrix", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.run_matrix() == 0
