#!/usr/bin/env python3
"""Where the port's k-way merge kernel spends its time, on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_merge_breakdown.py [--log2n 28] [--reps 3]

It builds the ``ooc`` phase's merge round on the card: 4 sorted runs of
2^log2n uniform uint32 keys (the carrier) with an int32 index leaf, cut by
``merge_path_partition`` into output tiles of 4096 (``chip_smoke.py``'s
round), 1024 and 256 (``oocsort``'s default tile).  For each tile it times
``kway_merge_round`` in variants: the round as the ooc path runs it
("full"), keys only ("keys_only"), and the short-tile kernel and the
tree kernel whatever the tile ("small_kernel", "tree_kernel", through
the private ``merge._kway_merge_probe``); and ``torch.sort(stable=True)``
of the same keys as the yardstick.  "full" is checked against the plain
version at the smaller sizes of ``--check`` (``chip_smoke.py`` holds the
kernel to it at full size); the other variants compute the same round.
Prints one JSON line per tile, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)

KWAY = 4


def sorted_runs(torch, log2n, dev):
    """KWAY runs of 2^log2n uniform uint32 keys, each sorted, back to back
    in one carrier buffer padded to the widest tile, and an index leaf."""
    from repro_torch.core import bijection
    from repro_torch.kernels.fused import pad_length
    m = 1 << log2n
    gen = torch.Generator(device=dev).manual_seed(1611)
    runs = []
    for _ in range(KWAY):
        x = torch.randint(-2**31, 2**31, (m,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        runs.append(bijection.sortable(torch.sort(bijection.sortable(x))
                                       .values))
    n = KWAY * m
    pad = pad_length(n, 4096) - n
    keys = torch.cat(runs + [runs[0].new_full((pad,), -1)])
    del runs
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    return keys, vals, [m] * KWAY


def breakdown(torch, keys, vals, lens, tile, reps):
    from repro_torch.kernels import merge
    n = sum(lens)
    tables = merge.merge_path_partition(keys, lens, KWAY, tile)
    g = tables[0].numel()
    alt_k, alt_v = torch.empty_like(keys), torch.empty_like(vals)
    kw = dict(kway=KWAY, tpb=tile, n=n)
    probe = dict(kway=KWAY, tpb=tile)
    cases = {
        "full": lambda: merge.kway_merge_round(
            keys, (vals,), alt_k, (alt_v,), *tables, **kw),
        "keys_only": lambda: merge.kway_merge_round(
            keys, (), alt_k, (), *tables, **kw),
        "small_kernel": lambda: merge._kway_merge_probe(
            keys, (vals,), alt_k, (alt_v,), *tables, kernel="small", **probe),
        "tree_kernel": lambda: merge._kway_merge_probe(
            keys, (vals,), alt_k, (alt_v,), *tables, kernel="tree", **probe)}
    out = {name: chip_smoke.cuda_ms(torch, fn, reps)
           for name, fn in cases.items()}
    vb = vals.element_size()
    table_bytes = sum(t.numel() * 4 for t in tables)
    out.update(tiles=g, bound_ms=chip_smoke.bound_ms(
        2 * keys.numel() * (keys.element_size() + vb) + table_bytes),
        keys_only_bound_ms=chip_smoke.bound_ms(
            2 * keys.numel() * keys.element_size() + table_bytes))
    return out


def check(torch, log2n, dev):
    """The full round against the plain version at 2^log2n keys a run."""
    from repro_torch.kernels import merge, ref
    keys, vals, lens = sorted_runs(torch, log2n, dev)
    n = sum(lens)
    for tile in (4096, 256):
        tables = merge.merge_path_partition(keys, lens, KWAY, tile)
        kw = dict(kway=KWAY, tpb=tile, n=n)
        got = merge.kway_merge_round(keys, (vals,), torch.empty_like(keys),
                                     (torch.empty_like(vals),), *tables, **kw)
        want = ref.kway_merge_round_ref(keys, (vals,), torch.empty_like(keys),
                                        (torch.empty_like(vals),), *tables,
                                        **kw)
        chip_smoke.need(torch.equal(got[0][:n], want[0][:n]) and
                        torch.equal(got[1][0][:n], want[1][0][:n]),
                        f"merge (tile {tile}) != plain version")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=28)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--check", type=int, default=20,
                        help="log2 of the run length held to the plain "
                             "version")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_merge_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    chip_smoke.build()
    check(torch, args.check, dev)
    torch.cuda.empty_cache()
    keys, vals, lens = sorted_runs(torch, args.log2n, dev)
    from repro_torch.core import bijection
    srt = bijection.sortable(keys[:sum(lens)])
    lib = chip_smoke.cuda_ms(torch, lambda: torch.sort(srt, stable=True),
                             args.reps)
    del srt
    torch.cuda.empty_cache()
    for tile in (4096, 1024, 256):
        chip_smoke.emit({"phase": "merge_breakdown", "n": sum(lens),
                         "kway": KWAY, "tile": tile, "torch_sort_ms": lib,
                         **breakdown(torch, keys, vals, lens, tile,
                                     args.reps)})
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
