"""The traffic generator: a cell's inputs, made on the device from the
seed by one ``torch.Generator``.

A traffic mix is a data file, ``traffic/<name>.json``::

    {"inputs": 2,
     "columns": {"keys": {"dist": "and", "ands": 3},
                 "values": {"dist": "uniform"}}}

``inputs`` distinct inputs are made, each a dict of the configuration's
``columns`` (name -> dtype name, in order) of ``records`` values each,
column after column, input after input, so one seed always gives the
same inputs.  A column the mix does not name is uniform.  Distributions:

* ``uniform``: every bit of the dtype uniform; with ``high``, integers
  uniform in ``[0, high)`` (bucket ids);
* ``and``: the AND of ``ands + 1`` uniform words, Thearling and Smith's
  entropy ladder (each bit set with probability 2^-(ands+1));
* ``zipf``: Zipf(``a``) ranks 1, 2, ... (numpy's ``Generator.zipf`` law,
  drawn by the same rejection method), capped at the dtype's largest
  value; with ``n``, ranks above ``n`` are drawn again and the column
  holds ``rank - 1``: bucket ids in ``[0, n)``, the first the heaviest.

A mix whose inputs this cannot draw names a module of its own,
``"generator": "<name>"``, found as ``generators/<name>.py``, whose
``make(config, traffic, gen, device)`` returns the list of inputs.
"""
from __future__ import annotations

import torch

#: unsigned dtypes are drawn as their signed twin's bits and viewed
SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16,
          torch.uint32: torch.int32, torch.uint64: torch.int64}


def _uniform_bits(n: int, dtype, gen: torch.Generator, device) -> torch.Tensor:
    lo = torch.iinfo(dtype).min
    return torch.empty(n, dtype=dtype, device=device).random_(
        lo, None, generator=gen)


def _zipf(n: int, a: float, top: int, gen: torch.Generator,
          device) -> torch.Tensor:
    """Zipf(a) ranks in ``[1, top]`` by Devroye's rejection method (as
    numpy draws them), in int64; ranks above ``top`` are drawn again."""
    if a <= 1.0:
        raise ValueError("zipf needs a > 1")
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, dtype=torch.float64, generator=gen,
                             device=device)
        v = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1) & (x <= top) & (v * x * (t - 1.0) / (b - 1.0)
                                      <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    return out


def draw(n: int, dtype_name: str, spec: dict, gen: torch.Generator,
         device) -> torch.Tensor:
    """One column of ``n`` values of ``dtype_name`` by ``spec``."""
    view = getattr(torch, dtype_name)
    bits = SIGNED.get(view, view)
    dist = spec.get("dist", "uniform")
    if dist == "uniform" and "high" in spec:
        x = torch.empty(n, dtype=bits, device=device).random_(
            0, int(spec["high"]), generator=gen)
    elif dist == "uniform":
        x = _uniform_bits(n, bits, gen, device)
    elif dist == "and":
        x = _uniform_bits(n, bits, gen, device)
        for _ in range(int(spec["ands"])):
            x &= _uniform_bits(n, bits, gen, device)
    elif dist == "zipf":
        width = 8 * torch.empty((), dtype=bits).element_size()
        top = (1 << width) - 1 if view != bits else (1 << width - 1) - 1
        if "n" in spec:
            x = _zipf(n, float(spec["a"]), int(spec["n"]), gen, device) - 1
        else:
            x = _zipf(n, float(spec["a"]), 2 ** 62 - 1, gen, device).clamp_(
                max=min(top, (1 << 63) - 1))
        if width < 64:       # above the signed range: two's complement
            x = torch.where(x >= 1 << width - 1, x - (1 << width), x)
        x = x.to(bits)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return x.view(view)


def make_columns(config: dict, traffic: dict, gen: torch.Generator,
                 device) -> list:
    """The general generator: ``inputs`` inputs of the configuration's
    columns, each drawn by the mix's spec for it."""
    n = int(config["records"])
    specs = traffic.get("columns", {})
    return [{name: draw(n, dtype, specs.get(name, {}), gen, device)
             for name, dtype in config["columns"].items()}
            for _ in range(int(traffic.get("inputs", 2)))]


def make_inputs(config: dict, traffic: dict, seed: int, device,
                load_module=None) -> list:
    """The cell's distinct inputs, ``[{column: tensor, ...}, ...]``, by the
    general generator or the module the mix names (``load_module(kind,
    name)`` finds it)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    name = traffic.get("generator")
    make = make_columns if name is None else \
        load_module("generators", name).make
    return make(config, traffic, gen, device)


def input_bytes(inp: dict) -> int:
    return sum(t.numel() * t.element_size() for t in inp.values())
