"""Fault-tolerant training loop (port of ``repro.train.trainer``).

  * restart-exact data (batch = f(seed, step) — nothing to persist),
  * async checkpoints every N steps with atomic publish + hash verification,
  * resume = restore(latest) and continue at step+1.

The reference's ``jax.jit`` has no counterpart: a step runs eagerly.  Its
buffer donation becomes updating in place: with ``donate=True`` (the
default) the step writes the new parameters and optimizer state into the
tensors of the state it is given; ``donate=False`` works on copies and
leaves the given state untouched.  A step reads nothing back to the host:
the loss, the norm, the learning rate and the step counter stay 0-d
tensors on the device.

Microbatches: the batch is split along its leading axis and each slice's
gradient of ``loss / microbatches`` is accumulated by autograd into each
parameter's ``.grad``, in the parameter's dtype, in slice order: the
reference's ``scan`` sums ``grad / microbatches`` into ``zeros_like``
accumulators of the parameters' dtypes the same way, with no float32 copy
of the gradients (17 GB at Qwen3-30B-A3B's width with six layers).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core.interop import resolve_device, tree_flatten
from repro_torch.models import loss_fn
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               get_optimizer)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32 on the parameters' device


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.detach().clone()


def make_train_step(cfg, optimizer_name: Optional[str] = None,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, max_grad_norm: float = 1.0,
                    donate: bool = True, microbatches: int = 1,
                    engine: Optional[str] = None):
    """The train step: grad(loss) -> clip -> schedule -> update.

    Returns ``(opt, step_fn)``; ``step_fn(state, batch) -> (state,
    metrics)`` with ``metrics`` holding 0-d tensors ``loss`` (the mean
    over the microbatches), ``grad_norm`` (before the clip), ``lr``, and
    the last microbatch's ``ce`` and ``aux``.  ``engine`` goes to the MoE
    dispatch (``None``: the kernels on CUDA, argsort on the CPU).
    """
    opt = get_optimizer(optimizer_name or cfg.optimizer)
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, opt_state = state.params, state.opt_state
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        leaves, _ = tree_flatten(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            parts = {k: torch.as_tensor(v).chunk(microbatches, dim=0)
                     for k, v in batch.items()}
            slices = [{k: v[i] for k, v in parts.items()}
                      for i in range(microbatches)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in slices:
                mb_loss, metrics = loss_fn(params, cfg, mb, remat=cfg.remat,
                                           engine=engine)
                (mb_loss / microbatches).backward()
                loss = loss + mb_loss.detach() / microbatches
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _grads(params)
        for p in leaves:
            p.grad = None
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(state.step)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        out = TrainState(params, opt_state, state.step + 1)
        return out, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                     **{k: v.detach() for k, v in metrics.items()}}

    return opt, step_fn


def _grads(params):
    """The ``.grad`` tree of ``params`` (zeros where a leaf got none).  A
    DTensor parameter's gradient takes the parameter's placements (its
    partial sums reduced, its shards cut), as the reference's gradients
    take the parameters' shardings."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_grads(v) for v in params)
    g = params.grad if params.grad is not None \
        else torch.zeros_like(params)
    if isinstance(g, DTensor) and g.placements != params.placements:
        g = g.redistribute(params.device_mesh, params.placements)
    return g


@dataclasses.dataclass
class Trainer:
    cfg: Any
    data: Any                              # .batch(step) -> dict
    ckpt_dir: str
    ckpt_every: int = 50
    log_every: int = 10
    base_lr: float = 3e-4
    total_steps: int = 1000
    device: Optional[str] = None           # the GPU unless "cpu" is given
    #: passed to ``make_train_step`` (the reference's trainer takes one);
    #: a full-width model needs several to fit its activations
    microbatches: int = 1

    def init_or_resume(self, generator_or_seed) -> TrainState:
        """Fresh parameters from ``init_params`` (a ``torch.Generator`` on
        the device, or an int seed), then the newest checkpoint in
        ``ckpt_dir`` if there is one."""
        from repro_torch.models import init_params
        dev = resolve_device(self.device)
        gen = generator_or_seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        params = init_params(self.cfg, gen, device=dev)
        opt, self._step_fn = make_train_step(
            self.cfg, base_lr=self.base_lr, total_steps=self.total_steps,
            microbatches=self.microbatches)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        last = latest_step(self.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(self.ckpt_dir, last, state)
            print(f"[trainer] resumed from step {last}")
        self._ckpt = AsyncCheckpointer(self.ckpt_dir)
        return state

    def run(self, state: TrainState, num_steps: int,
            on_step: Optional[Callable] = None) -> TrainState:
        """``num_steps`` steps from ``state.step``; the host reads only at
        ``log_every`` (and whatever ``on_step`` reads)."""
        t0 = time.time()
        start = int(state.step)
        for s in range(start, start + num_steps):
            batch = self.data.batch(s)
            state, metrics = self._step_fn(state, batch)
            if on_step is not None:
                on_step(s, state, metrics)
            if (s + 1) % self.log_every == 0:
                dt = (time.time() - t0) / (s - start + 1)
                print(f"[trainer] step {s+1} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms/step")
            if (s + 1) % self.ckpt_every == 0:
                self._ckpt.save(s + 1, state)
        self._ckpt.wait()
        return state
