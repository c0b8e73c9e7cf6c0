"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-param
qwen3-family MoE with the paper's sort-based expert dispatch, trained for
a few hundred steps with checkpointing (resume works: re-run the same
command after killing it).

The port of ``examples/train_moe.py``: the same configs, data and
trainer settings.  Its checkpoints are the port's own format, which the
reference's store cannot read (nor the port the reference's), so the
default directory is a different one.

    PYTHONPATH=src python examples/torch_train_moe.py --steps 200
    PYTHONPATH=src python examples/torch_train_moe.py --steps 200 --small --device cpu

Without a card and without ``--device cpu`` it stops with the port's "no
CUDA device" error before printing anything.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.interop import resolve_device, tree_flatten  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def make_cfg(small: bool):
    base = get_config("qwen3_moe_30b_a3b")        # same family, scaled down
    if small:
        return dataclasses.replace(
            base, name="qwen3-moe-micro", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab=1024,
            num_experts=8, top_k=2, dtype="float32", vocab_pad_multiple=16)
    return dataclasses.replace(
        base, name="qwen3-moe-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=512, vocab=32000,
        num_experts=16, top_k=4, dtype="float32")


def param_count(params) -> int:
    """Elements over the parameter tree."""
    return sum(t.numel() for t in tree_flatten(params)[0])


def run(steps=200, small=False, seq_len=None, batch=None,
        ckpt="checkpoints/train_moe_torch", device=None) -> dict:
    """Train to ``steps`` (resuming from ``ckpt``'s newest checkpoint).
    Returns the parameter count, the step it started from, each step's
    loss by its 1-based number, and the wall seconds of the steps."""
    dev = resolve_device(device)
    cfg = make_cfg(small)
    seq = seq_len or (64 if small else 256)
    batch = batch or (4 if small else 8)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           device=str(dev))
    tr = Trainer(cfg, data, ckpt, ckpt_every=50, log_every=10,
                 base_lr=1e-3, total_steps=steps, device=str(dev))
    state = tr.init_or_resume(0)
    n = param_count(state.params)
    print(f"[example] {cfg.name}: {n/1e6:.1f}M params, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, sort-based dispatch")
    start = int(state.step)
    losses = []
    t0 = time.perf_counter()
    tr.run(state, steps - start,
           on_step=lambda s, st, m: losses.append(m["loss"]))
    seconds = time.perf_counter() - t0
    got = torch.stack(losses).tolist() if losses else []
    return {"params": n, "start": start, "seconds": seconds,
            "losses": {start + i + 1: v for i, v in enumerate(got)}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt", default="checkpoints/train_moe_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    run(steps=args.steps, small=args.small, seq_len=args.seq_len,
        batch=args.batch, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
