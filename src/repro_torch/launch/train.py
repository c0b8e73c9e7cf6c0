"""Training entry point, ``python -m repro_torch.launch.train --arch <id>``
(port of ``repro.launch.train``).

Config -> parameters on the card -> fault-tolerant trainer -> checkpoints,
on one GPU (``--device cpu`` runs it on the CPU; without a GPU and without
that flag it raises).  ``--smoke`` takes the reduced same-family config.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.interop import resolve_device, tree_flatten
from repro_torch.data import SyntheticLMData
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seq = args.seq_len or (128 if args.smoke else 4096)
    gb = args.global_batch or (8 if args.smoke else 256)
    dev = resolve_device(args.device)

    data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq, global_batch=gb,
                           num_patches=cfg.num_patches
                           if cfg.frontend == "vision_patches" else 0,
                           d_model=cfg.d_model, device=str(dev))
    tr = Trainer(cfg, data, f"{args.ckpt_dir}/{cfg.name}",
                 ckpt_every=args.ckpt_every, base_lr=args.lr,
                 total_steps=args.steps, device=str(dev))
    state = tr.init_or_resume(0)
    n = sum(t.numel() for t in tree_flatten(state.params)[0])
    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, seq={seq}, batch={gb}, "
          f"devices={devices}")
    return tr.run(state, args.steps)


if __name__ == "__main__":
    main()
