"""Serving example: batched generation with the sort-scheduled engine, on
the PyTorch/CUDA port.

The port of ``examples/serve_decode.py``: the same config, queue and
lines.  The parameters come from ``init_params`` with a ``torch``
generator seeded 0, whose draws differ from ``jax.random``'s, so the
generated tokens differ from the reference's; carried across with
``models.params_from_reference`` the reference's own parameters give its
tokens.

    PYTHONPATH=src python examples/torch_serve_decode.py                # the card
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu   # the CPU

Without a card and without ``--device cpu`` it stops with the port's "no
CUDA device" error before printing anything.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.interop import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "internlm2_1_8b"


def run(device=None, params=None, requests=10) -> list:
    """The example; ``params`` (on ``device``) replaces the seeded ones.
    Returns the batches of served requests."""
    dev = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    engine = ServeEngine(cfg, params, batch_size=4, max_len=128, device=dev)

    rng = np.random.default_rng(0)
    queue = [Request(rid=i,
                     prompt=rng.integers(0, cfg.vocab,
                                         int(rng.integers(4, 16))),
                     max_new_tokens=int(rng.integers(8, 32)))
             for i in range(requests)]

    # a counting pass over the remaining-length class
    batches = engine.schedule(queue)
    print(f"{len(queue)} requests -> {len(batches)} batches "
          f"(sorted by remaining-length class to cut straggler idle)")
    served = []
    for b, reqs in enumerate(batches):
        done = engine.generate(reqs)
        for r in done:
            print(f"  batch {b} req {r.rid}: prompt_len={len(r.prompt)} "
                  f"generated={len(r.generated)} tokens, "
                  f"first5={r.generated[:5]}")
        served.append(done)
    return served


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the engine serves (default: the card)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
