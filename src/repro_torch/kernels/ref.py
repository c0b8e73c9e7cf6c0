"""Plain PyTorch versions of the CUDA kernels (the correctness ground truth).

Each function has exactly its kernel's contract: the same tables, the same
padded buffers and outputs.  The wrappers run them for tensors that lie on
the CPU (the kernel engine's path in the CPU tests), and ``chip_smoke.py``
holds every kernel to them on the card.  They favour clarity and O(n)
memory over speed; they are no yardstick of speed.

Keys are in the port's carrier (see ``core.bijection``): digits come from
``(carrier >> lo) & mask`` and order from ``sortable(carrier)``.

The trash slot: the fused pass writes every position ``[0, n)`` of its
output buffers; the kernel and this version both leave slot ``n`` and the
padding after it unspecified (the reference scattered masked lanes there).
"""
from __future__ import annotations

import torch

from repro_torch.core.bijection import sortable


#: unsigned (and bool) dtypes -> the signed twin that carries their bits
_SIGNED_TWIN = {torch.bool: torch.int8, torch.uint8: torch.int8,
                torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def signed_bits(t: torch.Tensor):
    """``(view, logical)``: an unsigned (or bool) tensor viewed as its signed
    twin, whose shifts must then be logical, or a signed tensor as it is.

    PyTorch has no ``>>``, ``minimum`` or gather for ``uint32`` / ``uint64``,
    so the library entry points that take a key's own dtype compute on this
    view; the reference shifts unsigned keys logically and signed ones
    arithmetically, which differ where ``shift + width`` passes the top bit.
    """
    twin = _SIGNED_TWIN.get(t.dtype)
    return (t, False) if twin is None else (t.view(twin), True)


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def int_view(t: torch.Tensor) -> torch.Tensor:
    """Any 1, 2, 4 or 8-byte tensor viewed as the signed integer of its
    size (the row network compares and moves bits)."""
    return t if t.dtype in _INT_OF_SIZE.values() else t.view(
        _INT_OF_SIZE[t.element_size()])


def _digits(keys: torch.Tensor, lo: int, width: int,
            logical: bool = False) -> torch.Tensor:
    """int64 digits ``(keys >> lo) & (2^width - 1)`` of a signed tensor:
    an arithmetic shift, or a logical one for the bits of an unsigned key
    (``signed_bits``).  A shift past the top bit gives the sign fill or 0,
    as XLA's shifts do.  The shifted key keeps the key's own width, so a
    digit wider than the key (8-bit keys at widths 9..16) has no bits
    above it, as on the card."""
    bits = keys.element_size() * 8
    # widen before masking: an 8-bit mask does not fit an int8 carrier
    d = keys.to(torch.int64) >> min(lo, 63)
    if logical and lo:
        d = d & ((1 << (bits - lo)) - 1) if lo < bits else torch.zeros_like(d)
    return d & ((1 << min(width, bits)) - 1)


def radix_histogram_ref(keys: torch.Tensor, shift: int,
                        width: int) -> torch.Tensor:
    """(T, KPB) integer keys -> (T, 2^width) int32 per-tile digit counts
    (unsigned dtypes shift logically, signed ones arithmetically)."""
    keys, logical = signed_bits(keys)
    t = keys.shape[0]
    r = 1 << width
    rows = torch.arange(t, device=keys.device).unsqueeze(1)
    flat = (rows * r + _digits(keys, shift, width, logical)).reshape(-1)
    out = torch.zeros(t * r, dtype=torch.int32, device=keys.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.reshape(t, r)


def _lanes(starts: torch.Tensor, counts: torch.Tensor):
    """Flatten rows of (start, count) into per-lane (row, position)."""
    counts = counts.to(torch.int64)
    row = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    excl = torch.cumsum(counts, 0) - counts
    lane = torch.arange(row.shape[0], device=counts.device) - excl[row]
    return row, starts.to(torch.int64)[row] + lane


def fused_counting_pass_ref(src_keys, src_vals, alt_keys, alt_vals, sc,
                            blk_seg, blk_off, blk_reset, blk_count,
                            blk_active, base_excl, next_sid, *, kpb: int,
                            r: int, a_max: int, n: int,
                            lookahead: bool = False):
    """One counting pass over flat descriptor rows (see ``fused.py``).

    Writes the partitioned keys and values into the alternate buffers and
    returns ``(alt_keys, alt_vals, hist[, hist2])``.  ``sc`` is the 6-tuple
    of digit windows.  Every row's lanes are flattened (the rows partition
    ``[0, n)``) and ranked stably per (region, digit) with one stable
    sort, which gives each its in-segment carry over the earlier rows of
    its region and its rank in its own row at once.
    """
    lo, width, nlo, nwidth, n2lo, n2width = (list(sc) + [0, 0])[:6]
    dev = src_keys.device
    seg, off, reset, count, active = (t.reshape(-1).to(torch.int64) for t in
                                      (blk_seg, blk_off, blk_reset,
                                       blk_count, blk_active))
    rows = torch.nonzero(count > 0).squeeze(1)
    nrows = rows.shape[0]
    row, pos = _lanes(off[rows], count[rows])
    keys = src_keys[pos]
    act = active[rows][row] == 1
    dest = pos.clone()

    hists = [torch.zeros(a_max * r, dtype=torch.int32, device=dev)
             for _ in range(2 if lookahead else 1)]
    a_row, a_key = row[act], keys[act]
    digit = _digits(a_key, lo, width)
    # a lane's slot in its segment's digit bucket: its stable rank among the
    # active lanes of the same (region, digit), the in-segment carry over
    # the region's earlier rows and the rank in its own row at once (a
    # region restarts where reset == 1; lanes run in row order)
    idx = torch.arange(nrows, device=dev)
    first = torch.cummax(torch.where(reset[rows] == 1, idx,
                                     torch.zeros_like(idx)), 0).values
    group, order = torch.sort(first[a_row] * r + digit, stable=True)
    is_start = torch.ones_like(group, dtype=torch.bool)
    is_start[1:] = group[1:] != group[:-1]
    lane = torch.arange(group.shape[0], device=dev)
    rank = torch.empty_like(group)
    rank[order] = lane - torch.cummax(torch.where(
        is_start, lane, torch.zeros_like(lane)), 0).values
    del group, order, is_start, lane
    a_seg = seg[rows][a_row]
    dest[act] = (base_excl.reshape(-1).to(torch.int64)[a_seg * r + digit] +
                 rank)

    alt_keys[dest] = keys
    for sv, dv in zip(src_vals, alt_vals):
        dv[dest] = sv[pos]

    sid = next_sid.reshape(-1).to(torch.int64)[a_seg * r + digit]
    for h, (wlo, wid) in zip(hists, ((nlo, nwidth), (n2lo, n2width))):
        if wid > 0:
            live = sid < a_max
            bins = sid[live] * r + _digits(a_key[live], wlo, wid)
            h.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    return (alt_keys, tuple(alt_vals), *hists)


def bitonic_sort_rows_stable_ref(keys: torch.Tensor, idx: torch.Tensor):
    """Sort (S, L) rows by (key, idx) lexicographically."""
    o1 = torch.sort(idx, dim=1, stable=True).indices
    k1, i1 = torch.gather(keys, 1, o1), torch.gather(idx, 1, o1)
    o2 = torch.sort(sortable(k1), dim=1, stable=True).indices
    return torch.gather(k1, 1, o2), torch.gather(i1, 1, o2)


# ---- the library surface's oracles (the reference's ``ref.py``) ----------

def tile_multisplit_ref(keys: torch.Tensor, shift: int, width: int):
    """(T, KPB) keys -> (keys digit-major within each tile, by a stable
    order; the sorted digits; each output slot's rank in its digit run; the
    (T, 2^width) histograms) — the reference's oracle, keys untruncated."""
    order, digit = _tile_order(keys, shift, width)
    return _multisplit_outputs(keys, order, digit, width)


def bitonic_sort_rows_ref(keys: torch.Tensor, values=None):
    """(S, L) -> rows sorted ascending; values permuted alongside by a
    *stable* argsort — the reference's oracle, which is not the KV
    kernel's contract under duplicate keys (see ``bitonic_rows_ref``)."""
    b = int_view(keys)
    kind = row_kind(keys.dtype)
    if kind in _FLOAT8_KINDS:
        raise TypeError(f"the row-sort oracle does not take {keys.dtype} "
                        f"keys (XLA's sort comparator for float8 is not "
                        f"ported; the network, bitonic_rows_ref, takes them)")
    if kind in NIBBLE_KINDS:
        b = _row_network_prepare(b, kind)
    key = _row_order_key(b, kind)
    if kind not in ("u", "s", *NIBBLE_KINDS):
        # XLA's sort comparator on the CPU: every NaN last, -0 == +0, and
        # f32 / f64 / bf16 subnormals equal to zero (flushed)
        exp, mant = _FLOAT_BITS[kind]
        mag = b & ~torch.iinfo(b.dtype).min
        zero = mag == 0 if kind == "f16" else mag < (1 << mant)
        key = torch.where(mag > exp, torch.iinfo(b.dtype).max,
                          torch.where(zero, 0, key))
    order = torch.sort(key, dim=1, stable=True).indices
    out = torch.gather(b, 1, order).view(keys.dtype)
    if values is None:
        return out
    return out, torch.gather(values, 1, order)


def onehot_matmul_hist_ref(keys: torch.Tensor, shift: int, width: int):
    """Flat (2^width,) histogram over all tiles."""
    return radix_histogram_ref(keys, shift, width).sum(0, dtype=torch.int32)


# ---- the library kernels' plain versions --------------------------------

#: the compare kinds of the row network, by key dtype
_ROW_KIND = {torch.bool: "u", torch.uint8: "u", torch.uint16: "u",
             torch.uint32: "u", torch.uint64: "u", torch.int8: "s",
             torch.int16: "s", torch.int32: "s", torch.int64: "s",
             torch.float16: "f16", torch.bfloat16: "bf16",
             torch.float32: "f32", torch.float64: "f64",
             torch.float8_e4m3fn: "e4m3fn", torch.float8_e5m2: "e5m2",
             torch.float8_e4m3fnuz: "e4m3fnuz",
             torch.float8_e5m2fnuz: "e5m2fnuz",
             torch.float8_e8m0fnu: "e8m0fnu", torch.int4: "i4",
             torch.uint4: "u4"}
#: float kinds: (the largest magnitude that is not a NaN, mantissa bits);
#: a magnitude above it is a NaN.  The fnuz kinds' one NaN is the bit
#: pattern of -0 (the sign bit alone), and e8m0fnu has no sign bit: its
#: bits are an unsigned exponent, all ones the NaN.
_FLOAT_BITS = {"f16": (0x7C00, 10), "bf16": (0x7F80, 7),
               "f32": (0x7F800000, 23), "f64": (0x7FF0000000000000, 52),
               "e4m3fn": (0x7E, 3), "e5m2": (0x7C, 2),
               "e4m3fnuz": (0x7F, 3), "e5m2fnuz": (0x7F, 2),
               "e8m0fnu": (0x7E, 0)}
_FNUZ = ("e4m3fnuz", "e5m2fnuz")
_FLOAT8_KINDS = ("e4m3fn", "e5m2", *_FNUZ, "e8m0fnu")
#: 4-bit integer kinds: one value per byte, in its low nibble (the high
#: nibble is not part of the value, and the reference returns it 0)
NIBBLE_KINDS = ("i4", "u4")


def row_kind(dtype: torch.dtype) -> str:
    kind = _ROW_KIND.get(dtype)
    if kind is None:
        raise TypeError(f"the row network does not take {dtype} keys")
    return kind


def _row_order_key(b: torch.Tensor, kind: str) -> torch.Tensor:
    """A signed tensor whose order is the keys' order (floats: totalOrder,
    -0 below +0), from the signed bit view ``b``."""
    lo = torch.iinfo(b.dtype).min
    if kind in ("u", "e8m0fnu"):
        return b ^ lo
    if kind == "s":
        return b
    if kind == "u4":
        return b & 0xF
    if kind == "i4":
        return (b & 0xF) ^ 0x8
    return torch.where(b < 0, b ^ ~lo, b)


def _row_nan(b: torch.Tensor, kind: str) -> torch.Tensor:
    """The NaN lanes of the float bit view ``b``."""
    if kind in _FNUZ:
        return b == torch.iinfo(b.dtype).min
    if kind == "e8m0fnu":
        return b == -1
    return (b & ~torch.iinfo(b.dtype).min) > _FLOAT_BITS[kind][0]


def _row_network_prepare(b: torch.Tensor, kind: str) -> torch.Tensor:
    """What the reference's first min/max stage does to float bits besides
    ordering them: XLA on the CPU flushes subnormal f32 / f64 / bf16
    operands to a zero of their sign (f16 is widened to f32 first and keeps
    them), turns every bf16 NaN into the quiet NaN of its sign and every
    float8_e5m2 NaN into +NaN (0x7F).  The other float8 kinds keep their
    subnormals and NaNs.  Every lane passes a min or a max in every stage,
    so doing this once before the network (rows of L >= 2) is the same.
    The 4-bit kinds keep their low nibble (their value) at any L."""
    if kind in NIBBLE_KINDS:
        return b & 0xF
    if kind == "e5m2":
        return torch.where(_row_nan(b, kind), 0x7F, b).to(b.dtype)
    if kind not in ("f32", "f64", "bf16"):
        return b
    lo = torch.iinfo(b.dtype).min
    exp, mant = _FLOAT_BITS[kind]
    mag = b & ~lo
    b = torch.where((mag != 0) & (mag < (1 << mant)), b & lo, b)
    if kind == "bf16":
        b = torch.where(mag > exp, (b & lo) | 0x7FC0, b)
    return b


def bitonic_rows_ref(keys: torch.Tensor, vals=None):
    """The reference's row network replayed stage by stage: ``size_log``
    ascending, ``stride_log`` descending, partner ``i ^ stride``, lane i
    keeps ``min(k_i, k_p)`` when ``ascending == is_lower`` and
    ``max(k_i, k_p)`` otherwise; a value moves to the partner's iff its
    lane's key compares ``!=`` after the step (not stable).

    ``min``/``max`` are XLA's: NaN propagates (with one NaN operand, that
    NaN; with two, ``min`` keeps its own operand unless it is negative and
    ``max`` unless it is positive), ``min(+0, -0) = -0``, ``max = +0``.
    float8_e8m0fnu's smallest value 0x00 (2^-127, a float32 subnormal)
    compares as zero, below every other value, and where a min or max
    returns it the result is 0xFF, the NaN (XLA's zero does not convert
    back).  Returns the sorted keys, or ``(keys, values)`` when ``vals``
    is given.
    """
    kind = row_kind(keys.dtype)
    b = int_view(keys)
    v = None if vals is None else int_view(vals)
    s, length = b.shape
    if length & (length - 1):
        raise ValueError("row length must be a power of two")
    if length >= 2 or kind in NIBBLE_KINDS:
        b = _row_network_prepare(b, kind)
    is_float = kind not in ("u", "s", *NIBBLE_KINDS)
    if is_float:
        mag = ~torch.iinfo(b.dtype).min if kind != "e8m0fnu" else -1
    idx = torch.arange(length, device=b.device)
    for size_log in range(1, length.bit_length()):
        size = 1 << size_log
        for stride_log in range(size_log - 1, -1, -1):
            part = idx ^ (1 << stride_log)
            take_min = ((idx & size) == 0) == (part > idx)
            y = b[:, part]
            ox, oy = _row_order_key(b, kind), _row_order_key(y, kind)
            min_x, max_x = ox <= oy, ox >= oy
            if is_float:
                xn, yn = _row_nan(b, kind), _row_nan(y, kind)
                xneg, both = b < 0, ~xn & ~yn
                min_x = (xn & (~yn | ~xneg)) | (both & min_x)
                max_x = (xn & (~yn | xneg)) | (both & max_x)
            new = torch.where(torch.where(take_min, min_x, max_x), b, y)
            if kind == "e8m0fnu":
                new = torch.where(new == 0, -1, new).to(b.dtype)
            if v is not None:
                moved = new != b
                if is_float:
                    moved = (_row_nan(new, kind) | _row_nan(b, kind) |
                             (moved & (((new | b) & mag) != 0)))
                v = torch.where(moved, v[:, part], v)
            b = new
    out = b.view(keys.dtype)
    return out if vals is None else (out, v.view(vals.dtype))


#: key and value dtypes the reference's multisplit accepts (its 16-bit
#: halves overflow the 0xFFFF mask constant for int8 / uint8 / int16)
MULTISPLIT_DTYPES = (torch.uint16, torch.int32, torch.uint32, torch.int64,
                     torch.uint64)


def check_multisplit_dtypes(keys: torch.Tensor, vals=None) -> None:
    for t in (keys,) if vals is None else (keys, vals):
        if t.dtype not in MULTISPLIT_DTYPES:
            raise TypeError(f"multisplit takes {MULTISPLIT_DTYPES} keys "
                            f"and values, got {t.dtype}")


def _tile_order(keys: torch.Tensor, shift: int, width: int):
    b, logical = signed_bits(keys)
    digit = _digits(b, shift, width, logical)
    return torch.sort(digit, dim=1, stable=True).indices, digit


def _multisplit_outputs(keys, order, digit, width):
    b, _ = signed_bits(keys)
    t, kpb = b.shape
    r = 1 << width
    sd = torch.gather(digit, 1, order)
    hist = torch.zeros((t, r), dtype=torch.int32, device=b.device)
    hist.scatter_add_(1, digit, torch.ones_like(digit, dtype=torch.int32))
    excl = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    pos = torch.arange(kpb, dtype=torch.int32, device=b.device)
    rank = pos - torch.gather(excl, 1, sd)
    return (torch.gather(b, 1, order).view(keys.dtype), sd.to(torch.int32),
            rank, hist)


def low_bits_mask(nbits: int, nbytes: int) -> int:
    """The bits of an ``nbytes`` element that survive the reference
    multisplit's round trip through ``ceil(nbits / 16)`` exact 16-bit
    halves: the low ``16 * ceil(nbits / 16)``."""
    if nbits < 1:
        raise ValueError(f"key_bits / val_bits must be >= 1, got {nbits}")
    return (1 << min(16 * -(-nbits // 16), 8 * nbytes)) - 1


def _keep_low_bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    mask = low_bits_mask(nbits, x.element_size())
    if mask == (1 << 8 * x.element_size()) - 1:
        return x
    return (signed_bits(x)[0] & mask).view(x.dtype)


def tile_multisplit_kv_ref(keys: torch.Tensor, vals, shift: int, width: int,
                           key_bits: int, val_bits: int = 32):
    """The multisplit kernels' plain version: ``tile_multisplit_ref`` with
    keys (and, when ``vals`` is given, values moved alongside) truncated as
    the reference's exact 16-bit-half permutation leaves them.  Returns
    ``(keys, digits, ranks, hist)`` or ``(keys, vals, digits, ranks,
    hist)``."""
    check_multisplit_dtypes(keys, vals)
    order, digit = _tile_order(keys, shift, width)
    sk, sd, rank, hist = _multisplit_outputs(keys, order, digit, width)
    sk = _keep_low_bits(sk, key_bits)
    if vals is None:
        return sk, sd, rank, hist
    vb, _ = signed_bits(vals)
    sv = _keep_low_bits(torch.gather(vb, 1, order).view(vals.dtype),
                         val_bits)
    return sk, sv, sd, rank, hist


def assigned_histogram_ref(keys: torch.Tensor, tile_idx: torch.Tensor,
                           valid: torch.Tensor, shift: int,
                           width: int) -> torch.Tensor:
    """(G, 2^width) int32: row g is the histogram of tile ``tile_idx[g]``
    times ``valid[g]``.  An index in [-T, -1] counts from the end and the
    result is clamped to [0, T-1], as the reference's block index is."""
    t = keys.shape[0]
    if t == 0:
        raise ValueError("assigned_histogram needs at least one tile")
    idx = tile_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)
    hist = radix_histogram_ref(signed_bits(keys)[0][idx].view(keys.dtype),
                               shift, width)
    return hist * valid.to(torch.int32).unsqueeze(1)


def sort_segments_ref(buf: torch.Tensor, perm, starts: torch.Tensor,
                      sizes: torch.Tensor, length: int, leaves=()) -> None:
    """Sort each bucket ``buf[start:start+size]`` (size <= length) in place
    by (key, position), moving each of ``leaves`` (indexed along its first
    dimension) in place with its keys; write source positions into
    ``perm`` if given."""
    live = sizes > 0
    row, pos = _lanes(starts[live], sizes[live])
    keys = buf[pos]
    o1 = torch.sort(sortable(keys), stable=True).indices
    src = pos[o1[torch.sort(row[o1], stable=True).indices]]
    buf[pos] = buf[src]
    for v in leaves:
        bits = int_view(v)
        bits[pos] = bits[src]
    if perm is not None:
        perm[pos] = src.to(perm.dtype)


def merge_rows_ref(hist: torch.Tensor, local_threshold: int,
                   merge_threshold: int):
    """R3 over each (A, r) row: (group_start, group_done) bool tables.

    A sub-bucket of size 0 extends its group and leaves the running sum as
    it is, so the walk visits only the columns where some row is non-zero
    (all of them on dense tables; a few thousand of 65 536 at d = 16 on
    small inputs) and fills the rest as (False, True)."""
    cols = torch.nonzero(hist.any(0)).flatten()
    sizes = hist[:, cols].t().contiguous()
    acc = torch.full((hist.shape[0],), merge_threshold, dtype=torch.int32,
                     device=hist.device)
    starts, dones = [], []
    for s in sizes:
        big = s > local_threshold
        extend = (s == 0) | (~big & (acc + s < merge_threshold))
        acc = torch.where(extend, acc + s,
                          torch.where(big, merge_threshold, s))
        starts.append(~extend)
        dones.append(~big)
    gstart = torch.zeros(hist.shape, dtype=torch.bool, device=hist.device)
    gdone = torch.ones_like(gstart)
    if starts:
        gstart[:, cols] = torch.stack(starts, 1)
        gdone[:, cols] = torch.stack(dones, 1)
    return gstart, gdone


def _tile_rank_ref(skeys, live, takes, *, kway: int, tpb: int, rank: str):
    """Rank of every window element under (key, run, lane) order.

    ``skeys`` (G, kway, tpb) are the windows in the ``sortable`` domain,
    ``live`` their live-lane mask (a prefix of each window), ``takes``
    (G, kway) the live counts.  Returns (G, kway * tpb) int64 ranks, exact
    for live elements and arbitrary for dead ones.  ``"searchsorted"``: own
    lane + per run-pair binary searches (<= in earlier runs, < in later
    ones); ``"counting"``: the all-pairs comparison rank.
    """
    g = skeys.shape[0]
    kf = skeys.reshape(g, kway * tpb)
    flat = torch.arange(kway * tpb, device=skeys.device)
    if rank == "counting":
        lf = live.reshape(g, kway * tpb)
        before = lf[:, None, :] & (
            (kf[:, None, :] < kf[:, :, None]) |
            ((kf[:, None, :] == kf[:, :, None]) &
             (flat[None, :] < flat[:, None])))
        return before.sum(dim=2)
    # dead lanes mask to the all-ones sentinel (the sortable maximum), so
    # every row stays sorted; counts clip to the live prefix
    win = torch.where(live, skeys, torch.iinfo(skeys.dtype).max)
    run_of = flat // tpb
    out = (flat % tpb).expand(g, -1).clone()
    for r in range(kway):
        row = win[:, r, :].contiguous()
        le = torch.searchsorted(row, kf, side="right", out_int32=True)
        lt = torch.searchsorted(row, kf, side="left", out_int32=True)
        c = torch.where(run_of > r, le, torch.where(run_of < r, lt, 0))
        out += torch.minimum(c, takes[:, r:r + 1].to(c.dtype))
    return out


def kway_merge_round_ref(src_keys, src_vals, alt_keys, alt_vals, out_off,
                         out_cnt, win_start, win_take, *, kway: int, tpb: int,
                         n: int, rank: str = "searchsorted"):
    """One k-way merge round over descriptor tables (see ``merge.py``).

    Grid step g loads ``kway`` windows of ``tpb`` lanes at
    ``win_start[g*kway + r]`` (live lanes: the prefix ``< win_take``),
    ranks every element under (key, run, lane) order and writes key and
    value leaves to ``out_off[g] + rank`` when live and ``rank <
    out_cnt[g]``, else to the trash slot ``n``.  The buffers are
    ``pad_length``-sized, so every window load stays in bounds.  Tiles are
    processed in blocks of about 2^22 window lanes, so memory stays bounded
    at any n.  Returns ``(alt_keys, alt_vals)``, written in place.
    """
    if rank not in ("searchsorted", "counting"):
        raise ValueError(f"unknown tile rank mode {rank!r}")
    g_all = out_off.shape[0]
    dev = src_keys.device
    lane = torch.arange(tpb, device=dev)
    lanes = kway * tpb
    block = max(1, (1 << 22) // (lanes * (lanes if rank == "counting" else 1)))
    for g0 in range(0, g_all, block):
        g1 = min(g0 + block, g_all)
        g = g1 - g0
        starts = win_start.reshape(g_all, kway)[g0:g1].to(torch.int64)
        takes = win_take.reshape(g_all, kway)[g0:g1].to(torch.int64)
        pos = (starts[:, :, None] + lane).reshape(-1)
        keys = src_keys[pos]
        live = lane < takes[:, :, None]
        ranks = _tile_rank_ref(sortable(keys).reshape(g, kway, tpb), live,
                               takes, kway=kway, tpb=tpb, rank=rank)
        ok = live.reshape(g, -1) & (
            ranks < out_cnt[g0:g1].to(torch.int64)[:, None])
        dest = torch.where(ok, out_off[g0:g1].to(torch.int64)[:, None] +
                           ranks, n).reshape(-1)
        alt_keys[dest] = keys
        for sv, dv in zip(src_vals, alt_vals):
            dv[dest] = sv[pos]
    return alt_keys, tuple(alt_vals)
