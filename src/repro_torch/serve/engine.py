"""Batched serving engine: prefill + decode with a static-shape KV cache;
port of ``repro.serve.engine``.

The scheduler orders the admission queue with a counting pass on the
remaining-length class (``core.segmented.counting_partition`` into 256
buckets: on the GPU one prologue histogram and one fused counting pass) —
short-remaining requests are co-batched so a slot never idles behind a
long straggler longer than one class width.  Every decode step of an MoE
model dispatches its tokens with one ``capacity_dispatch`` per layer and
group, the same two kernels again.

Queues past device memory route the admission sort through the §5
out-of-core pipeline instead: an :class:`AdmissionConfig` switches
``schedule`` to ``core.outofcore.oocsort`` over the remaining-length
classes, with the device footprint bounded by ``spill_budget_bytes`` and
the ``core.faults`` resilience layer threaded straight through.

The reference compiles its decode step with ``jax.jit``; the port runs it
eagerly under ``torch.inference_mode()``.  Generated tokens stay on the
device until the batch is done: a decode step reads nothing back.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.interop import resolve_device
from repro_torch.core.segmented import counting_partition
from repro_torch.models import decode_step, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    generated: Optional[np.ndarray] = None


LENGTH_CLASS = 64                         # remaining-length bucket width


@dataclasses.dataclass
class AdmissionConfig:
    """Out-of-core admission sorting for queues past device memory.

    When set on :class:`ServeEngine`, ``schedule`` orders the queue through
    ``core.outofcore.oocsort`` instead of a single device counting pass:
    the remaining-length classes stream through chunk sorts + k-way merge
    rounds, device bytes bounded by ``spill_budget_bytes`` /
    ``device_slab_elems``, and ``faults`` (a ``FaultPolicy``), ``retry``
    (a ``RetryPolicy``) and ``checkpoint_dir`` ride along so an admission
    sort over a huge queue retries, degrades and resumes instead of
    dropping the queue.
    """
    chunk_elems: int
    spill_budget_bytes: Optional[int] = None
    device_slab_elems: Optional[int] = None
    faults: Optional[object] = None       # core.faults.FaultPolicy
    retry: Optional[object] = None        # core.faults.RetryPolicy
    checkpoint_dir: Optional[str] = None


class ServeEngine:
    """Serves ``cfg`` with ``params`` on ``device`` (the GPU unless the
    caller says otherwise; without one this raises), where the parameters
    must already be.  ``dispatch_engine`` selects the partition engine of
    the admission pass and of every MoE dispatch (``None``: the kernels on
    CUDA, argsort on the CPU)."""

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 admission: Optional[AdmissionConfig] = None, *,
                 device=None, dispatch_engine: Optional[str] = None):
        dev = resolve_device(device)
        have = params["embed"].device
        if have.type != dev.type or (dev.index is not None
                                     and have.index != dev.index):
            raise ValueError(f"the parameters are on {have}, not on {dev}")
        self.cfg, self.params = cfg, params
        self.device = have
        self.batch = batch_size
        self.max_len = max_len
        self.admission = admission
        self.dispatch_engine = dispatch_engine

    def _decode(self, token, cache):
        return decode_step(self.params, self.cfg, token, cache,
                           engine=self.dispatch_engine)

    def schedule(self, queue: List[Request]) -> List[List[Request]]:
        """Sort-based admission: group by remaining-length class (one counting
        pass — or the resilient out-of-core route under an
        :class:`AdmissionConfig`), then fill fixed-size batches class-major."""
        if not queue:
            return []
        cls = [min(r.max_new_tokens // LENGTH_CLASS, 255) for r in queue]
        if self.admission is not None:
            from repro_torch.core.outofcore import oocsort
            adm = self.admission
            _, order = oocsort(
                np.asarray(cls, np.uint32), adm.chunk_elems,
                values=np.arange(len(queue), dtype=np.int32),
                spill_budget_bytes=adm.spill_budget_bytes,
                device_slab_elems=adm.device_slab_elems,
                faults=adm.faults, retry=adm.retry,
                checkpoint_dir=adm.checkpoint_dir, device=self.device)
        else:
            part = counting_partition(torch.tensor(cls, dtype=torch.int32,
                                                   device=self.device), 256,
                                      engine=self.dispatch_engine)
            order = part.perm.cpu().numpy()
        return [[queue[j] for j in order[i:i + self.batch]]
                for i in range(0, len(queue), self.batch)]

    def _prefill(self, reqs: List[Request]):
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch, s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt       # left-pad
        cache = init_cache(self.cfg, self.batch, self.max_len,
                           device=self.device)
        # teacher-forced prefill through the decode path (single code path,
        # static shapes; production would use a chunked prefill kernel)
        tokens = torch.from_numpy(toks).to(self.device)
        logits = None
        for t in range(s):
            logits, cache = self._decode(tokens[:, t:t + 1], cache)
        return logits, cache

    def _next(self, logits):
        """Greedy: the lowest id among the largest logits of the real
        vocabulary."""
        return torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1)[:, None]

    def generate(self, reqs: List[Request]):
        """Greedy decoding of the first ``batch_size`` requests; sets each
        one's ``generated`` (its ``max_new_tokens`` ids) and returns them."""
        reqs = reqs[: self.batch]
        with torch.inference_mode():
            logits, cache = self._prefill(reqs)
            max_new = max(r.max_new_tokens for r in reqs)
            outs = torch.zeros((self.batch, max_new), dtype=torch.int32,
                               device=self.device)
            cur = self._next(logits)
            for t in range(max_new):
                outs[:, t] = cur[:, 0]
                logits, cache = self._decode(cur.to(torch.int32), cache)
                cur = self._next(logits)
            outs = outs.cpu().numpy()
        for i, r in enumerate(reqs):
            r.generated = outs[i, : r.max_new_tokens]
        return reqs
