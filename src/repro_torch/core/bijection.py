"""Order-preserving bijections from primitive key types to radix-sortable bits.

Paper §4.6: radix sorting operates on unsigned integers; signed ints and IEEE
floats are mapped to an order-preserving unsigned representation before the
first counting pass and mapped back at the end (Herf, "Radix tricks", 2001):

  * unsigned ints: identity
  * signed ints:   flip the sign bit
  * floats:        if sign bit set -> flip ALL bits, else -> flip sign bit only

Floats follow IEEE-754 totalOrder: every bit pattern round-trips, ``-0.0``
sorts just below ``+0.0``, negative-signed NaNs sort below ``-inf`` and
positive-signed NaNs above ``+inf``, ordered among themselves by payload.

The carrier convention (one convention, used everywhere in the port)
--------------------------------------------------------------------
PyTorch has no ``>>``, ``bincount`` or ``searchsorted`` on ``uint32`` /
``uint64``, so the port carries ordered bits in the *signed twin* dtype
(int8/16/32/64).  The carrier's **bit pattern is the reference's unsigned
ordered key, unchanged** (``carrier.numpy().view(uint)`` equals
``repro.core.bijection.to_ordered_bits``).  Consequences:

  * digits: ``(carrier >> lo) & mask`` — the arithmetic shift only smears
    copies of the top bit above bit ``k - lo``, which the mask drops, so
    digits are exactly the unsigned key's digits;
  * order: a signed compare of the carrier is NOT the key order; compare
    ``sortable(carrier)`` (top bit flipped) instead.  The CUDA kernels read
    the carrier as unsigned and compare directly;
  * sentinel: the reference's all-ones pad is the carrier's ``-1``.

``CompressionPlan`` packs the live bit columns of the ordered-bits domain
into a contiguous low window (entropy-adaptive compressed keys); see the
reference module for the argument that packing preserves order.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

# torch key dtype -> (signed carrier dtype, key bit width)
_CARRIER = {
    torch.uint8: (torch.int8, 8),
    torch.uint16: (torch.int16, 16),
    torch.uint32: (torch.int32, 32),
    torch.uint64: (torch.int64, 64),
    torch.int8: (torch.int8, 8),
    torch.int16: (torch.int16, 16),
    torch.int32: (torch.int32, 32),
    torch.int64: (torch.int64, 64),
    torch.float32: (torch.int32, 32),
    torch.float64: (torch.int64, 64),
    torch.bfloat16: (torch.int16, 16),
    torch.float16: (torch.int16, 16),
}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)

# numpy key dtype name -> (unsigned carrier dtype, key bit width); by name so
# ml_dtypes' bfloat16 resolves without importing it
_CARRIER_NP = {
    "uint8": (np.uint8, 8), "uint16": (np.uint16, 16),
    "uint32": (np.uint32, 32), "uint64": (np.uint64, 64),
    "int8": (np.uint8, 8), "int16": (np.uint16, 16),
    "int32": (np.uint32, 32), "int64": (np.uint64, 64),
    "float32": (np.uint32, 32), "float64": (np.uint64, 64),
    "bfloat16": (np.uint16, 16), "float16": (np.uint16, 16),
}
_BITS_TO_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32,
                   64: torch.int64}


def key_bits(dtype) -> int:
    """Number of key bits k for a supported torch or numpy key dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _CARRIER:
            raise TypeError(f"unsupported key dtype {dtype}")
        return _CARRIER[dtype][1]
    name = np.dtype(dtype).name
    if name not in _CARRIER_NP:
        raise TypeError(f"unsupported key dtype {name}")
    return _CARRIER_NP[name][1]


def carrier_dtype(dtype: torch.dtype) -> torch.dtype:
    """Signed carrier dtype the radix sort runs on for a torch key dtype."""
    if dtype not in _CARRIER:
        raise TypeError(f"unsupported key dtype {dtype}")
    return _CARRIER[dtype][0]


def signed_value(v: int, bits: int) -> int:
    """The signed integer with the same ``bits``-wide pattern as ``v``."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _min(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).min


def sortable(carrier: torch.Tensor) -> torch.Tensor:
    """Carrier with the top bit flipped: its signed order is the key order."""
    return carrier ^ _min(carrier.dtype)


def to_ordered_bits(keys: torch.Tensor) -> torch.Tensor:
    """Map keys of any supported dtype to the order-preserving carrier."""
    dt = keys.dtype
    cdt = carrier_dtype(dt)
    if dt in _UNSIGNED:
        return keys.view(cdt)
    if dt in _SIGNED:
        return keys ^ _min(cdt)
    bits = keys.view(cdt)
    return torch.where(bits < 0, ~bits, bits ^ _min(cdt))


def from_ordered_bits(carrier: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_ordered_bits`."""
    cdt = carrier_dtype(dtype)
    carrier = carrier.to(cdt)
    if dtype in _UNSIGNED:
        return carrier.view(dtype)
    if dtype in _SIGNED:
        return carrier ^ _min(cdt)
    was_neg = carrier >= 0        # encoded negatives have the top bit clear
    return torch.where(was_neg, ~carrier, carrier ^ _min(cdt)).view(dtype)


def to_ordered_bits_np(keys: np.ndarray) -> np.ndarray:
    """NumPy mirror of :func:`to_ordered_bits`, in the reference's unsigned
    representation (bit-for-bit the carrier's pattern)."""
    keys = np.asarray(keys)
    name = keys.dtype.name
    if name not in _CARRIER_NP:
        raise TypeError(f"unsupported key dtype {name}")
    udt = np.dtype(_CARRIER_NP[name][0])
    if np.issubdtype(keys.dtype, np.unsignedinteger):
        return keys.astype(udt, copy=False)
    bits = keys.view(udt)
    sign = udt.type(1 << (np.iinfo(udt).bits - 1))
    if np.issubdtype(keys.dtype, np.signedinteger):
        return bits ^ sign
    neg = (bits & sign) != 0
    return np.where(neg, ~bits, bits ^ sign)


def from_ordered_bits_np(ubits: np.ndarray, dtype) -> np.ndarray:
    """NumPy mirror of :func:`from_ordered_bits`."""
    dt = np.dtype(dtype)
    udt = np.dtype(_CARRIER_NP[dt.name][0])
    ubits = np.asarray(ubits).astype(udt, copy=False)
    if np.issubdtype(dt, np.unsignedinteger):
        return ubits.astype(dt, copy=False)
    sign = udt.type(1 << (np.iinfo(udt).bits - 1))
    if np.issubdtype(dt, np.signedinteger):
        return (ubits ^ sign).view(dt)
    was_neg = (ubits & sign) == 0
    return np.where(was_neg, ~ubits, ubits ^ sign).view(dt)


def _tree_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce a 1-D tensor with a binary bitwise op by pairwise halving
    (torch has no OR/AND reduction); stays on the device, no host read."""
    while x.numel() > 1:
        h = x.numel() // 2
        y = op(x[:h], x[h:2 * h])
        if x.numel() % 2:
            y[:1] = op(y[:1], x[-1:])
        x = y
    return x


def bit_summary(carrier: torch.Tensor) -> Tuple[int, int]:
    """(OR, AND) of every carrier value as unsigned Python ints.

    Both reductions run on the carrier's device; the only transfer is the
    two scalars (one device-to-host read).  Requires a non-empty input.
    """
    flat = carrier.reshape(-1)
    both = torch.cat([_tree_reduce(flat, torch.bitwise_or),
                      _tree_reduce(flat, torch.bitwise_and)])
    bits = torch.iinfo(carrier.dtype).bits
    orv, andv = (int(v) & ((1 << bits) - 1) for v in both.tolist())
    return orv, andv


# ---------------------------------------------------------------------------
# Compressed keys: pack out globally-dead bit columns (entropy adaptation)
# ---------------------------------------------------------------------------

_WIDTH_TO_UNSIGNED = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


class CompressionPlan(NamedTuple):
    """Static bit-packing plan over the ordered-bits domain.

    ``mask`` marks the live columns, ``dead`` holds the constant value every
    key shares on the remaining columns, and ``source_bits`` is the carrier
    width both are defined over (all unsigned Python ints).
    """

    mask: int
    dead: int
    source_bits: int

    @property
    def packed_bits(self) -> int:
        """Live-bit count, at least 1 (an all-equal set packs to zeros)."""
        return max(1, bin(self.mask).count("1"))

    def runs(self) -> List[Tuple[int, int, int]]:
        """Contiguous live-bit runs as ``(src_lo, width, dst_lo)`` triples,
        least-significant first."""
        out: List[Tuple[int, int, int]] = []
        m, bit, dst = self.mask, 0, 0
        while m >> bit:
            while not (m >> bit) & 1:
                bit += 1
            lo = bit
            while bit < self.source_bits and (m >> bit) & 1:
                bit += 1
            out.append((lo, bit - lo, dst))
            dst += bit - lo
        return out


def _packed_width(plan: CompressionPlan) -> int:
    for width in sorted(_WIDTH_TO_UNSIGNED):
        if plan.packed_bits <= width:
            return width
    raise ValueError(f"packed width {plan.packed_bits} exceeds 64 bits")


def packed_carrier_dtype(plan: CompressionPlan) -> torch.dtype:
    """Smallest signed carrier that holds the packed live bits."""
    return _BITS_TO_SIGNED[_packed_width(plan)]


def packed_carrier_dtype_np(plan: CompressionPlan) -> np.dtype:
    """Smallest unsigned numpy dtype that holds the packed live bits."""
    return np.dtype(_WIDTH_TO_UNSIGNED[_packed_width(plan)])


def source_carrier_dtype(plan: CompressionPlan) -> torch.dtype:
    """Signed carrier of the (uncompressed) ordered-bits domain."""
    return _BITS_TO_SIGNED[plan.source_bits]


def source_carrier_dtype_np(plan: CompressionPlan) -> np.dtype:
    """Unsigned numpy dtype of the (uncompressed) ordered-bits domain (the
    reference's ``source_carrier_dtype``)."""
    return np.dtype(_WIDTH_TO_UNSIGNED[plan.source_bits])


def _plan_from_summary(orv: int, andv: int, bits: int) -> CompressionPlan:
    mask = orv ^ andv
    return CompressionPlan(mask=mask, dead=andv & ~mask, source_bits=bits)


def compression_plan(carrier: torch.Tensor) -> CompressionPlan:
    """Build a plan from a carrier tensor: one OR- and one AND-reduce on its
    device.  An empty key set gets the identity plan."""
    bits = torch.iinfo(carrier.dtype).bits
    if carrier.numel() == 0:
        return CompressionPlan(mask=(1 << bits) - 1, dead=0, source_bits=bits)
    return _plan_from_summary(*bit_summary(carrier), bits)


def compression_plan_np(ubits: np.ndarray) -> CompressionPlan:
    """NumPy mirror of :func:`compression_plan` on unsigned ordered bits."""
    ubits = np.asarray(ubits)
    bits = np.iinfo(ubits.dtype).bits
    if ubits.size == 0:
        return CompressionPlan(mask=(1 << bits) - 1, dead=0, source_bits=bits)
    flat = ubits.reshape(-1)
    return _plan_from_summary(int(np.bitwise_or.reduce(flat)),
                              int(np.bitwise_and.reduce(flat)), bits)


def _run_mask(width: int, plan: CompressionPlan, bits: int) -> int:
    return signed_value(((1 << width) - 1) & ((1 << plan.source_bits) - 1),
                        bits)


def pack_ordered_bits(carrier: torch.Tensor,
                      plan: CompressionPlan) -> torch.Tensor:
    """Drop the dead columns: gather the live runs into a contiguous low
    window and narrow to the smallest carrier that holds them."""
    bits = torch.iinfo(carrier.dtype).bits
    acc = torch.zeros_like(carrier)
    for lo, width, dst in plan.runs():
        acc |= ((carrier >> lo) & _run_mask(width, plan, bits)) << dst
    return acc.to(packed_carrier_dtype(plan))


def unpack_ordered_bits(packed: torch.Tensor,
                        plan: CompressionPlan) -> torch.Tensor:
    """Exact inverse of :func:`pack_ordered_bits`: widen back to the source
    carrier (the sign extension is masked off), scatter the live runs home,
    and restore the dead-bit constant."""
    src = source_carrier_dtype(plan)
    x = packed.to(src)
    acc = torch.full(packed.shape, signed_value(plan.dead, plan.source_bits),
                     dtype=src, device=packed.device)
    for lo, width, dst in plan.runs():
        acc |= ((x >> dst) & _run_mask(width, plan, plan.source_bits)) << lo
    return acc


def pack_ordered_bits_np(ubits: np.ndarray, plan: CompressionPlan) -> np.ndarray:
    """NumPy mirror of :func:`pack_ordered_bits` on unsigned bits."""
    src = np.dtype(ubits.dtype)
    acc = np.zeros(ubits.shape, dtype=src)
    for lo, width, dst in plan.runs():
        m = src.type(((1 << width) - 1) & ((1 << plan.source_bits) - 1))
        acc |= ((ubits >> src.type(lo)) & m) << src.type(dst)
    return acc.astype(packed_carrier_dtype_np(plan), copy=False)


def unpack_ordered_bits_np(packed: np.ndarray,
                           plan: CompressionPlan) -> np.ndarray:
    """NumPy mirror of :func:`unpack_ordered_bits` on unsigned bits."""
    src = source_carrier_dtype_np(plan)
    x = np.asarray(packed).astype(src, copy=False)
    acc = np.full(x.shape, src.type(plan.dead), dtype=src)
    for lo, width, dst in plan.runs():
        m = src.type(((1 << width) - 1) & ((1 << plan.source_bits) - 1))
        acc |= ((x >> src.type(dst)) & m) << src.type(lo)
    return acc
