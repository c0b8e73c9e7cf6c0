#!/usr/bin/env python3
"""Where the port's row network spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_rows_breakdown.py [--log2n 28] [--reps 3]

It times ``bitonic_sort_rows`` and ``bitonic_sort_rows_kv`` on 2^log2n
uniform uint32 keys cut into rows of 2048, 8192 and 16384: keys alone
and with int32 index values (32 lanes a thread) and with int64 values
(16 lanes a thread); then at rows of 8192 the [0, 1000) duplicate-heavy
keys, float32 keys with no NaN and with one NaN lane in 1024 (a lane
group holding a NaN runs the bit-level picks in shared memory), finite
float8_e4m3fn keys and ones with a NaN lane in 1024, and
``torch.sort(dim=1)`` of the same uint32 keys.  Each row-length line
carries the byte bound and the compute bound (the network's compare-
exchanges times 2 integer instructions for keys, 5 with values, at the
INT32 rate).  Every variant is held to the plain version on its first 64
rows first.  Prints one JSON line per row length and one for the key
kinds, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)


def bounds(torch, rows, length, kb, vb):
    lg = length.bit_length() - 1
    exchanges = rows * length // 2 * lg * (lg + 1) // 2
    return dict(byte_bound_ms=chip_smoke.bound_ms(2 * rows * length *
                                                  (kb + vb)),
                ops_bound_ms=chip_smoke.int_ops_ms(
                    torch, exchanges * (5 if vb else 2)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_rows_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitonic, ref
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    n = 1 << args.log2n
    rng = np.random.default_rng(1614)
    flat = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    ms = lambda fn: chip_smoke.cuda_ms(torch, fn, args.reps)  # noqa: E731

    def timed(keys, v=None):
        """ms of the row sort of ``keys`` (with ``v``), after holding its
        first 64 rows to the plain version."""
        sv = None if v is None else v[:64]
        err = chip_smoke._bits_err(torch, bitonic._network(keys[:64], sv),
                                   ref.bitonic_rows_ref(keys[:64], sv))
        chip_smoke.need(err == 0, f"row network ({keys.dtype}, "
                                  f"{keys.shape[1]}) != plain version")
        return ms(lambda: bitonic._network(keys, v))

    vals64 = vals.to(torch.int64)
    for length in (2048, 8192, 16384):
        keys = flat.reshape(-1, length)
        v, v64 = vals.reshape(-1, length), vals64.reshape(-1, length)
        rows = keys.shape[0]
        chip_smoke.emit({"phase": "rows_breakdown", "shape": [rows, length],
                         "keys_ms": timed(keys), "kv_ms": timed(keys, v),
                         "kv_int64_ms": timed(keys, v64),
                         "keys_bound": bounds(torch, rows, length, 4, 0),
                         "kv_bound": bounds(torch, rows, length, 4, 4),
                         "kv_int64_bound": bounds(torch, rows, length, 4, 8)})
    del vals64, v64
    keys, v = flat.reshape(-1, 8192), vals.reshape(-1, 8192)
    dup = torch.from_numpy(rng.integers(0, 1000, keys.shape).astype(
        np.uint32)).to(dev)
    f32_np = rng.standard_normal(keys.shape).astype(np.float32)
    f32 = torch.from_numpy(f32_np).to(dev)
    f32_np[rng.random(keys.shape) < 1 / 1024] = np.nan
    f32_nan = torch.from_numpy(f32_np).to(dev)
    del f32_np
    f8_bits = rng.integers(0, 256, keys.shape, dtype=np.uint8)
    f8_bits[(f8_bits & 0x7F) == 0x7F] = 0       # finite: no NaN lanes
    f8 = torch.from_numpy(f8_bits).to(dev).view(torch.float8_e4m3fn)
    f8_bits[rng.random(keys.shape) < 1 / 1024] = 0x7F
    f8_nan = torch.from_numpy(f8_bits).to(dev).view(torch.float8_e4m3fn)
    del f8_bits
    lib_keys = chip_smoke._uint_bits(torch, keys)
    out = {"phase": "rows_kinds", "shape": list(keys.shape)}
    for name, k in (("dup", dup), ("float32", f32), ("float32_nan", f32_nan),
                    ("float8_e4m3fn", f8), ("float8_e4m3fn_nan", f8_nan)):
        out[f"{name}_keys_ms"] = timed(k)
        out[f"{name}_kv_ms"] = timed(k, v)
    out["torch_sort_dim1_ms"] = ms(lambda: torch.sort(lib_keys, dim=1))
    chip_smoke.emit(out)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
