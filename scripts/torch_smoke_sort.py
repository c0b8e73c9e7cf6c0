"""Fast end-to-end sanity of the port's sorts: ``hybrid_sort`` at the
small test config over a ladder of sizes and five key kinds with values,
then the LSD baseline; prints ``SMOKE OK``.  The port of
``scripts/smoke_sort.py``: the same draws, sizes and config, the same
lines (a ``SortStats`` here holds Python numbers, not arrays).

    python scripts/torch_smoke_sort.py                # on the card
    python scripts/torch_smoke_sort.py --device cpu   # the CPU engine

On the card the sorts run the CUDA kernels (the default engine resolves
to ``kernel`` there); without a card and without ``--device cpu`` the
script stops with the port's "no CUDA device" error before printing
anything.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import SortConfig, hybrid_sort, lsd_sort  # noqa: E402
from repro_torch.core.interop import resolve_device  # noqa: E402

#: tiny threshold config so counting passes actually happen at small n
CFG = SortConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)
SIZES = (0, 1, 2, 7, 100, 1000, 20000)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def run(device=None, sizes=SIZES, n=5000) -> dict:
    """The smoke run; returns ``{label: SortStats}`` of every sort (None
    for the skipped empty input)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    stats_of = {}
    for m in sizes:
        x = rng.integers(0, 2**32, size=m, dtype=np.uint32)
        out, stats = (hybrid_sort(x, cfg=CFG, return_stats=True, device=dev)
                      if m else (x, None))
        ok = np.array_equal(np.sort(x), out if stats is None else _host(out))
        print(f"n={m:6d} ok={ok} stats={stats}")
        assert ok, f"FAIL n={m}"
        stats_of[f"n={m}"] = stats

    # values, skew, int32, float32
    for name, x in [
        ("uniform_u32", rng.integers(0, 2**32, n, dtype=np.uint32)),
        ("skew_and3", rng.integers(0, 2**32, n, dtype=np.uint32)
                      & rng.integers(0, 2**32, n, dtype=np.uint32)
                      & rng.integers(0, 2**32, n, dtype=np.uint32)),
        ("const", np.full(n, 12345, dtype=np.uint32)),
        ("int32", rng.integers(-2**31, 2**31, n).astype(np.int32)),
        ("f32", rng.standard_normal(n).astype(np.float32)),
    ]:
        v = np.arange(n, dtype=np.int32)
        ks, vs, stats = hybrid_sort(x, v, cfg=CFG, return_stats=True,
                                    device=dev)
        ks, vs = _host(ks), _host(vs)
        assert np.array_equal(np.sort(x), ks), f"keys FAIL {name}"
        assert np.array_equal(x[vs], ks), f"pair consistency FAIL {name}"
        print(f"{name:12s} passes={stats.counting_passes} "
              f"local={stats.used_local_sort} segs={stats.num_segments}")
        stats_of[name] = stats

    # LSD baseline
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    assert np.array_equal(np.sort(x), _host(lsd_sort(x, d=5, device=dev)))
    x = rng.standard_normal(3000).astype(np.float32)
    assert np.allclose(np.sort(x), _host(lsd_sort(x, d=4, device=dev)))
    print("LSD ok")
    print("SMOKE OK")
    return stats_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the sorts run (default: the card)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
