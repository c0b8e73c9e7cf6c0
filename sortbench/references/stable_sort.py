"""The plain reference of a key-value sort: ``torch.sort(stable=True)`` on
an int64 image of the keys that orders as the key dtype does, and one
gather of keys and values.  It imports nothing of the program.

The guarantees it holds the program to: keys ascending in their dtype's
order (signed keys as signed), equal keys keeping their input order
(stable), and every record kept with its value.

``control`` is the reference with one guarantee broken: it orders by the
high half of each key's bits only, as a sort that stopped after half its
digits would.
"""
from __future__ import annotations

import torch

#: the signed twin of each unsigned dtype: the same bits, which every CUDA
#: op accepts
_SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16,
           torch.uint32: torch.int32, torch.uint64: torch.int64}
#: the largest sum of each compared number over a run's checked outputs
#: that is still correct: the sort is exact
LIMITS = {"key_mismatch": 0, "value_mismatch": 0}


def _signed(t: torch.Tensor) -> torch.Tensor:
    return t.view(_SIGNED.get(t.dtype, t.dtype))


def order_image(keys: torch.Tensor) -> torch.Tensor:
    """int64 values whose order is the keys' dtype order: an unsigned
    key's bits with the top bit flipped order as signed ones do."""
    image = _signed(keys)
    if image.dtype is not keys.dtype:
        image = image ^ torch.iinfo(image.dtype).min
    return image.to(torch.int64)


def _gather(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return _signed(t)[index].view(t.dtype)


def _by(inp: dict, image: torch.Tensor) -> dict:
    index = torch.sort(image, stable=True).indices
    out = {"keys": _gather(inp["keys"], index)}
    if "values" in inp:
        out["values"] = _gather(inp["values"], index)
    return out


def reference(inp: dict, config: dict) -> dict:
    return _by(inp, order_image(inp["keys"]))


def control(inp: dict, config: dict) -> dict:
    bits = 8 * inp["keys"].element_size()
    return _by(inp, order_image(inp["keys"]) >> (bits // 2))


def mismatches(out, ref) -> int:
    """Positions at which ``out`` differs from ``ref`` (all of them when
    it is missing or of another length or dtype)."""
    if out is None or out.shape != ref.shape or out.dtype != ref.dtype:
        return ref.numel()
    return int((_signed(out) != _signed(ref)).sum().item())


def compare(out: dict, ref: dict) -> dict:
    """The numbers compared, each against a limit of 0."""
    got = {"key_mismatch": mismatches(out.get("keys"), ref["keys"])}
    if "values" in ref:
        got["value_mismatch"] = mismatches(out.get("values"), ref["values"])
    return got
