"""Distributed sort example (paper §5): 8 shards sort 2M keys, on the
PyTorch/CUDA port.

Shows the full pipeline — local hybrid sort, sampled splitters, capacity-
padded all_to_all, multiway merge — including the pipelined (chunked)
variant.  The port of ``examples/distributed_sort.py``: the same keys and
lines.  Its 8-device mesh becomes ``LocalMesh(8)``, all eight shards in
one process on one card (``LocalMesh(8, "cpu")`` with ``--device cpu``);
the port's meshes have one shard axis and no axis name.

    PYTHONPATH=src python examples/torch_distributed_sort.py                # the card
    PYTHONPATH=src python examples/torch_distributed_sort.py --device cpu   # the CPU

Without a card and without ``--device cpu`` it stops with the port's "no
CUDA device" error before printing anything.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (LocalMesh, make_distributed_sort,  # noqa: E402
                              valid_concat)

NSHARDS = 8
CASES = (("uniform s=1", 0, 1), ("skewed s=1", 3, 1),
         ("uniform s=4 (pipelined)", 0, 4))


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def run(device=None, n=1 << 21) -> dict:
    """The example; returns ``{case: (out_keys, out_ids or None,
    DistStats)}``, the sort's own outputs (tensors on the mesh's
    device)."""
    mesh = LocalMesh(NSHARDS, device)
    rng = np.random.default_rng(0)
    results = {}
    for name, ands, chunks in CASES:
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        for _ in range(ands):
            x &= rng.integers(0, 2**32, n, dtype=np.uint32)
        fn = make_distributed_sort(mesh, num_chunks=chunks)
        out, stats = fn(x)
        got = _host(valid_concat(out, stats.valid))
        valid = _host(stats.valid)
        ok = np.array_equal(np.sort(x), got)
        print(f"{name:24s} n={n} ok={ok} "
              f"attempts={int(_host(stats.exchange_attempts)[0])} "
              f"overflow={bool(_host(stats.overflow).any())} "
              f"shard fill={valid.mean() * NSHARDS / out.shape[0]:.2f}")
        results[name] = (out, None, stats)

    # payloads ride the exchange: sort (key, doc-id) pairs
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = np.arange(n, dtype=np.int32)
    fn = make_distributed_sort(mesh)
    out, out_ids, stats = fn(x, ids)
    gk = _host(valid_concat(out, stats.valid))
    gi = _host(valid_concat(out_ids, stats.valid))
    print(f"{'kv pairs':24s} n={n} ok={np.array_equal(x[gi], gk)} "
          f"perm ok={np.array_equal(np.sort(gi), ids)}")
    results["kv pairs"] = (out, out_ids, stats)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the shards live (default: the card)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
