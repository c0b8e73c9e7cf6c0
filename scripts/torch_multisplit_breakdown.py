#!/usr/bin/env python3
"""Where the port's tile multisplit spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_multisplit_breakdown.py [--log2n 28] [--reps 5]

It makes ``chip_smoke.py``'s library tiles from a seed ((⌈2^log2n / 6912⌉,
6912) uniform uint32 keys, int32 values) and times one launch of the
multisplit per variant, keys alone and with values, at width 8 (shift 24)
and width 12 (shift 20: two 8-bit rounds; width 16's (T, 65536) histograms
would be 10 GB): the tile load alone ("load"), the load and the
stable rank ("rank"), the load and the writes of an identity order
("write"), and the whole kernel ("full"), through the private
``multisplit._multisplit_probe``.  So the rank costs about full - write,
the writes write - load.  "full" is first held to the plain version
(``chip_smoke.py`` holds the public entry points); the partial variants'
outputs are not checked.  Prints one JSON line per (width, keys or KV),
with each variant's milliseconds and the byte bound, then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)

VARIANTS = ("load", "rank", "write", "full")


def breakdown(torch, keys, vals, shift, width, reps):
    from repro_torch.kernels import multisplit, ref
    args = (keys, vals, shift, width, 32, 32)
    got = multisplit._multisplit_probe(*args, "full")
    want = ref.tile_multisplit_kv_ref(*args)
    err = chip_smoke._bits_err(torch, got, want)
    chip_smoke.need(err == 0, f"multisplit (width {width}) != plain version")
    del got, want
    return {name: chip_smoke.cuda_ms(
        torch, lambda: multisplit._multisplit_probe(*args, name), reps)
        for name in VARIANTS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_multisplit_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    tiles = -(-(1 << args.log2n) // chip_smoke.LIB_KPB)
    keys = torch.from_numpy(np.random.default_rng(1614).integers(
        0, 2**32, (tiles, chip_smoke.LIB_KPB), dtype=np.uint32)).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device=dev).reshape(keys.shape)
    nt = keys.numel()
    for width, shift in ((8, 24), (12, 20)):
        for label, v in (("keys", None), ("kv", vals)):
            hist = tiles * (1 << width) * 4
            nbytes = nt * 4 + nt * 12 + hist + (2 * nt * 4 if v is not None
                                                 else 0)
            chip_smoke.emit({
                "phase": "multisplit_breakdown", "width": width,
                "moved": label, "shape": list(keys.shape),
                "bound_ms": chip_smoke.bound_ms(nbytes),
                "ms": breakdown(torch, keys, v, shift, width, args.reps)})
            torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
