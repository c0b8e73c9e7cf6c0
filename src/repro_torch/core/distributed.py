"""Distributed sample sort across shards (paper §5): port of
``repro.core.distributed``.

The algorithm is the reference's, stage for stage, for every shard:

  1. each of ``num_chunks`` chunks is sorted locally by ``hybrid_sort``
     (with an int32 index riding along when there are value leaves);
  2. per attempt: an evenly ranked sample of every sorted chunk, merged into
     one local sample; the samples of all shards gathered and merged, and
     ``nshards - 1`` splitters picked at even ranks; every key's
     destination shard, ties with a splitter cycled over their shard
     range; one ``counting_partition`` into ``nshards`` buckets, each
     bucket cut to the static ``capacity`` and exchanged (keys, value
     leaves, counts) by an all-to-all;
  3. while some (source, destination) cell overflowed, the attempt is
     replayed at ``refine``x the sample density, up to ``max_attempts``;
  4. the finish: ONE ``multiway_merge`` over the ``num_chunks · nshards``
     received runs, one 2-bucket ``counting_partition`` that moves the valid
     keys in front of the capacity padding, and ``from_ordered_bits``.

Meshes.  The reference runs the shard body under ``shard_map`` on one mesh
axis.  The port writes the body once over the list of shards a process
holds (``mesh.shards``): every stage runs for each held shard, then the
collective runs across them.  Two meshes give it its collectives:

  * :class:`LocalMesh` holds all ``nshards`` shards in one process on one
    device (the port's counterpart of the reference's fake host devices):
    ``all_to_all`` is one stack on the device, ``all_gather`` a stack;
  * :class:`ProcessGroupMesh` holds one shard per process of a
    ``torch.distributed`` group: NCCL ranks on their GPUs (the multi-GPU
    deployment) or gloo ranks on the CPU.  Its collectives are
    ``all_gather``, ``all_to_all_single`` with equal splits and
    ``all_reduce(MAX)``.

Every collective moves bytes: keys (the signed carrier), value leaves,
counts and samples cross as ``uint8`` views of contiguous rows and are
viewed back afterwards, so no backend's dtype list matters (gloo refuses
int16, the carrier of 16-bit keys) and float NaN payloads stay bit-exact.

Keys are the port's carrier (the signed twin holding the reference's
unsigned ordered bits); every comparison — the merges, the splitter
searches — runs on ``bijection.sortable(carrier)``, whose signed order is
the key order, and the reference's all-ones sentinel is the carrier's
``-1``.

The retry.  The reference replays an attempt under ``lax.cond`` on a
replicated ``psum`` predicate.  The port reads the replicated overflow flag
(an ``all_reduce(MAX)``) on the host once per attempt that could be
followed by another — counted in ``kernels._build.COUNTS["host_reads"]`` —
so every rank takes the same branch and only the attempts that run are
launched.

Launch census per shard, with C chunks and A executed attempts: prologue
histograms ``C·(1 + A) + 1``, fused passes the chunk sorts' executed
passes plus ``C·A + 1``, at most ``C·classes`` local sorts (the
reference's static form: ``ANALYSIS_CONTRACT`` there).  A ``LocalMesh``
counts every shard it holds.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bijection, interop, model
from repro_torch.core.hybrid import _MOVABLE, _read, hybrid_sort
from repro_torch.core.segmented import counting_partition, multiway_merge
from repro_torch.kernels import _build

_I32 = torch.int32
#: carrier dtype -> the unsigned dtype with the same bits (hybrid_sort's
#: input: its bijection leaves unsigned keys unchanged)
_UNSIGNED = {torch.int8: torch.uint8, torch.int16: torch.uint16,
             torch.int32: torch.uint32, torch.int64: torch.uint64}


class DistStats(NamedTuple):
    """Per-shard exchange ledger: one entry per shard the mesh holds
    (``nshards`` for a ``LocalMesh``, 1 for a process-group rank);
    replicated entries repeat the same value on every shard.

    exchange_attempts  executed splitter-refinement attempts (int32;
                       1 = the first splitter set fit)
    overflow           residual overflow after the last attempt (bool;
                       True means ``valid`` undercounts — capacity clipped)
    valid              number of real keys in this shard's output prefix
    peak_recv          max keys received over (chunk, source) rows
    """
    exchange_attempts: torch.Tensor
    overflow: torch.Tensor
    valid: torch.Tensor
    peak_recv: torch.Tensor


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _bytes(t: torch.Tensor) -> torch.Tensor:
    """Contiguous rows of ``t`` as a uint8 view (the last dim in bytes)."""
    return t.contiguous().view(torch.uint8)


def _on_device(device) -> torch.device:
    """``interop.resolve_device`` with the CUDA index made explicit, so a
    tensor's device compares equal to the mesh's."""
    dev = interop.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LocalMesh:
    """``nshards`` shards held by one process on one device.

    ``device=None`` is the GPU, and raises when there is none;
    ``device="cpu"`` is the caller's explicit choice.
    """

    def __init__(self, nshards: int, device=None):
        if nshards < 1:
            raise ValueError(f"nshards must be >= 1, got {nshards}")
        self.size = int(nshards)
        self.shards = tuple(range(self.size))
        self.device = _on_device(device)

    def _report(self, kind: str, nbytes: int) -> None:
        """Tell the launch recorder one shard's wire bytes of a collective
        (the reference's weights: ``size`` bytes at (P - 1) / P)."""
        _build.RECORDER.collective(kind, nbytes * (self.size - 1) / self.size)

    def all_gather(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """One equal-length row per shard -> (size, m), on every shard."""
        out = torch.stack([_bytes(r) for r in rows])
        if _build.RECORDER is not None:
            self._report("all_gather", out.numel())
        return out.view(rows[0].dtype)

    def all_to_all(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Shard i's (size, cap) block: row j goes to shard j, which
        receives the rows from every i as its own (size, cap) block."""
        out = torch.stack([_bytes(b) for b in blocks], dim=1)
        if _build.RECORDER is not None:
            self._report("all_to_all", out.numel() // self.size)
        return list(out.view(blocks[0].dtype).unbind(0))

    def any(self, flags: List[torch.Tensor]) -> torch.Tensor:
        """Replicated OR of one bool flag per shard (a device tensor); on
        the wire, the all-reduce of one int32 per shard."""
        if _build.RECORDER is not None:
            self._report("psum", 2 * 4)
        return torch.stack(flags).any()


class ProcessGroupMesh:
    """One shard per process of a ``torch.distributed`` group (default:
    the world group).

    The device follows the backend: ``cuda:<local rank>`` for NCCL
    (``LOCAL_RANK`` as torchrun sets it, else the rank modulo the visible
    cards); any other backend (gloo) runs where the caller says, which must
    be the CPU — a gloo group never stages CUDA tensors through the host.
    """

    def __init__(self, group=None, device=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.shards = (dist.get_rank(group),)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl":
            if device is None:
                local = int(os.environ.get(
                    "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
                device = torch.device("cuda", local)
            dev = _on_device(device)
            if dev.type != "cuda":
                raise ValueError("an NCCL group runs on CUDA devices")
        else:
            if device is None:
                raise ValueError(f"a {self.backend} group runs on the CPU: "
                                 f"pass device='cpu'")
            dev = torch.device(device)
            if dev.type != "cpu":
                raise ValueError(f"a {self.backend} group takes CPU tensors "
                                 f"only, not {dev}")
        self.device = dev

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"a {self.backend} mesh on {self.device} was "
                             f"given a tensor on {t.device}")

    def all_gather(self, rows: List[torch.Tensor]) -> torch.Tensor:
        (row,) = rows
        self._check(row)
        b = _bytes(row)
        parts = [torch.empty_like(b) for _ in range(self.size)]
        dist.all_gather(parts, b, group=self.group)
        return torch.stack(parts).view(row.dtype)

    def all_to_all(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        (block,) = blocks
        self._check(block)
        b = _bytes(block)
        out = torch.empty_like(b)
        dist.all_to_all_single(out, b, group=self.group)
        return [out.view(block.dtype)]

    def any(self, flags: List[torch.Tensor]) -> torch.Tensor:
        (flag,) = flags
        self._check(flag)
        t = flag.reshape(1).to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t[0].bool()


# ---------------------------------------------------------------------------
# the shard body's pieces (carrier keys throughout)
# ---------------------------------------------------------------------------

def _merge(runs: torch.Tensor, values=None):
    """``multiway_merge`` of (s, run_len) sorted carrier runs in key order."""
    out = multiway_merge(bijection.sortable(runs), values)
    if values is None:
        return bijection.sortable(out)
    return bijection.sortable(out[0]), out[1]


def _select_splitters(gsample_sorted: torch.Tensor, nshards: int,
                      oversample: int = 8) -> torch.Tensor:
    """(nshards - 1,) splitters from a sorted global sample: every
    ``oversample``-th entry of an ``oversample · nshards`` evenly ranked
    oversample, i.e. the even quantiles ``gsample[(i · total) // nshards]``.
    A sample smaller than the shard count repeats values, and the tie
    cycling of :func:`_dest_shards` spreads them."""
    total = gsample_sorted.shape[0]
    if total == 0 or nshards == 1:
        return gsample_sorted.new_zeros((nshards - 1,))
    s = max(1, int(oversample))
    ranks = (torch.arange(s * nshards, device=gsample_sorted.device) *
             total) // (s * nshards)
    return gsample_sorted[ranks][s::s]


def _even_sample_ranks(n: int, m: int, device=None) -> torch.Tensor:
    """m evenly spaced ranks into a length-n sorted array (sorted)."""
    return (torch.arange(m, device=device) * n) // m


def _local_sample(pieces, ranks: torch.Tensor) -> torch.Tensor:
    """A shard's sorted sample: the ranked entries of each sorted chunk,
    merged."""
    samples = torch.stack([pk[ranks] for pk, _ in pieces])
    return samples[0] if samples.shape[0] == 1 else _merge(samples)


def _make_splitters(local_samples: List[torch.Tensor], mesh,
                    sel_oversample: int = 8) -> torch.Tensor:
    """Global splitters from the held shards' sorted samples: gathered
    rows (each sorted) merged by ``multiway_merge`` — no sort."""
    g = mesh.all_gather(local_samples)                  # (nshards, m)
    gsorted = g.reshape(-1) if mesh.size == 1 else _merge(g)
    return _select_splitters(gsorted, mesh.size, oversample=sel_oversample)


def _dest_shards(sorted_keys: torch.Tensor, splitters: torch.Tensor,
                 nshards: int, my: int) -> torch.Tensor:
    """Destination shard (int32) per locally sorted carrier key.

    Ties with splitter values cycle across their allowed shard range,
    offset by the shard index ``my`` — only equal keys ever cross a
    splitter boundary, and the per-(source, dest) load stays bounded even
    for a constant key.  Searches compare ``bijection.sortable`` of both
    sides, the reference's unsigned ``jnp.searchsorted`` order.
    """
    keys = bijection.sortable(sorted_keys)
    spl = bijection.sortable(splitters)
    lo = torch.searchsorted(spl, keys, side="left").to(_I32)
    hi = torch.searchsorted(spl, keys, side="right").to(_I32)
    spread = hi - lo + 1
    first = torch.searchsorted(keys, keys, side="left").to(_I32)
    tie_rank = torch.arange(keys.shape[0], dtype=_I32,
                            device=keys.device) - first
    return lo + (tie_rank + my) % spread


def _sort_chunk(carrier: torch.Tensor, leaves, cfg, engine):
    """Stage 1: one chunk's local hybrid sort.  The chunk goes in as the
    unsigned view of its carrier (``hybrid_sort`` maps unsigned keys
    unchanged; handing it the signed carrier would flip the sign bit a
    second time), with ``narrow=False``: the reference sorts traced keys
    and schedules the full width.  Value leaves follow an int32 index, so
    the local sort moves one leaf whatever their number."""
    ukeys = carrier.view(_UNSIGNED[carrier.dtype])
    if not leaves:
        return bijection.to_ordered_bits(hybrid_sort(
            ukeys, cfg=cfg, engine=engine, narrow=False)), ()
    idx = torch.arange(carrier.shape[0], dtype=_I32, device=carrier.device)
    sk, sidx = hybrid_sort(ukeys, idx, cfg=cfg, engine=engine, narrow=False)
    return bijection.to_ordered_bits(sk), tuple(v[sidx] for v in leaves)


def _pack(sorted_keys, leaves, dest, nshards: int, capacity: int, engine):
    """One shard's send side: a stable counting partition by destination
    (one fused pass), each bucket's first ``capacity`` keys and leaves
    placed in its (nshards, capacity) row; the rest goes to the trash slot
    ``nshards · capacity``, which is cut off."""
    part = counting_partition(dest, nshards, engine=engine)
    ids = dest.to(torch.int64)
    position = part.dest - part.offsets[ids]
    kept = position < capacity
    trash = nshards * capacity
    slot = torch.where(kept, ids * capacity + position, trash)
    buf = torch.full((trash + 1,), -1, dtype=sorted_keys.dtype,
                     device=sorted_keys.device)
    buf[slot] = sorted_keys
    lbufs = []
    for leaf in leaves:
        lbuf = torch.zeros(trash + 1, dtype=leaf.dtype, device=leaf.device)
        lbuf[slot] = leaf
        lbufs.append(lbuf[:-1].reshape(nshards, capacity))
    sent = torch.clamp(part.counts, max=capacity)
    overflow = (part.counts > capacity).any()
    return (buf[:-1].reshape(nshards, capacity), tuple(lbufs),
            sent.reshape(nshards, 1), overflow)


def _exchange(sorted_keys, leaves, dests, nshards: int, capacity: int, mesh,
              engine):
    """Pack every held shard's chunk by destination, then exchange keys,
    each value leaf and the valid counts (one all-to-all each).  Arguments
    and results are lists over the held shards."""
    packed = [_pack(k, ls, d, nshards, capacity, engine)
              for k, ls, d in zip(sorted_keys, leaves, dests)]
    recv = mesh.all_to_all([p[0] for p in packed])
    recv_leaves = [mesh.all_to_all([p[1][i] for p in packed])
                   for i in range(len(leaves[0]))]
    counts = mesh.all_to_all([p[2] for p in packed])
    return (recv, [tuple(rl[s] for rl in recv_leaves)
                   for s in range(len(packed))],
            [c.reshape(nshards) for c in counts], [p[3] for p in packed])


def _merge_runs(runs: torch.Tensor):
    """The finish's one high-fan-in merge over the (C · nshards, capacity)
    received runs, with the flat slot id riding along."""
    slot_ids = torch.arange(runs.numel(), dtype=_I32,
                            device=runs.device).reshape(runs.shape)
    if runs.shape[0] == 1:
        return runs[0], slot_ids[0]
    return _merge(runs, slot_ids)


def _compact(merged, midx, leaves, counts, capacity: int, engine):
    """The 2-bucket counting pass that moves valid keys (slot below its
    run's count) in front of the padding, stably, and the gathers of the
    merged keys and of the leaves (through the merge's slot ids)."""
    midx = midx.to(torch.int64)
    ok = (torch.arange(capacity, dtype=_I32, device=merged.device)[None, :]
          < counts.reshape(-1, 1)).reshape(-1)[midx]
    perm = counting_partition((~ok).to(_I32), 2, engine=engine).perm.to(
        torch.int64)
    return merged[perm], [leaf.reshape(-1)[midx][perm] for leaf in leaves]


# ---------------------------------------------------------------------------
# the sort
# ---------------------------------------------------------------------------

def _to_mesh(x, mesh, what: str) -> torch.Tensor:
    """A numpy array onto the mesh's device; a tensor must already be
    there (nothing moves quietly)."""
    if isinstance(x, torch.Tensor):
        if x.device != mesh.device:
            raise ValueError(f"{what} on {x.device}, the mesh runs on "
                             f"{mesh.device}")
        return x
    return interop.to_tensor(x, mesh.device)


def make_distributed_sort(mesh, *, oversample: int = 64, slack: float = 2.0,
                          num_chunks: int = 1, max_attempts: int = 3,
                          refine: int = 4,
                          cfg: Optional[model.SortConfig] = None,
                          engine: Optional[str] = None):
    """Build the distributed sort over ``mesh`` (a :class:`LocalMesh` or a
    :class:`ProcessGroupMesh`).

    Returns ``fn(keys[, values]) -> (out_keys[, out_values], DistStats)``.
    ``keys`` (and each leaf of the optional value pytree) holds the shards
    this process holds, back to back: for a ``LocalMesh`` the global
    ``(nshards · n_local,)`` array, for a process-group rank its own
    ``(n_local,)`` shard.  Numpy inputs go to the mesh's device; tensors
    must already be there.  Each held shard's output is ``num_chunks ·
    nshards · capacity`` long, sorted and padded; the first
    ``stats.valid[i]`` entries of each concatenate to the global sorted
    sequence (:func:`valid_concat`).  ``oversample`` is the per-shard
    splitter sample, ``slack`` prices the exchange capacity, overflow
    replays up to ``max_attempts - 1`` refinements at ``refine``x sample
    density; ``cfg`` / ``engine`` go to the chunk sorts and the counting
    partitions.  On CUDA the kernels run or raise.
    """
    nshards = mesh.size
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")

    def dsort(keys, leaves):
        dev = keys.device
        held = len(mesh.shards)
        if keys.shape[0] % held:
            raise ValueError(f"{keys.shape[0]} keys do not split into "
                             f"{held} shards")
        n_local = keys.shape[0] // held
        carrier = bijection.to_ordered_bits(keys)
        cdt = carrier.dtype
        chunk = n_local // num_chunks
        # slack prices the skew splitter error leaves behind, the additive
        # term the binomial variance of a (source, dest) cell (~4 standard
        # deviations); a source never sends more than its whole chunk
        base = slack * chunk / nshards
        capacity = max(1, min(chunk,
                              int(base + 4.0 * math.sqrt(max(base, 1.0)))))
        out_len = num_chunks * nshards * capacity

        if chunk == 0:
            # degenerate: num_chunks > n_local — nothing to exchange
            zero = torch.zeros(held, dtype=_I32, device=dev)
            return (torch.full((held * out_len,), -1, dtype=cdt, device=dev),
                    [torch.zeros(held * out_len, dtype=v.dtype, device=dev)
                     for v in leaves],
                    DistStats(zero, torch.zeros(held, dtype=torch.bool,
                                                device=dev), zero, zero))
        if n_local % num_chunks:
            raise ValueError(
                f"n_local={n_local} must divide into num_chunks={num_chunks}")

        # stage 1: the local chunk sorts of every held shard (unrolled, as
        # in the reference: a loop that only labels the recorder's launches)
        loop = (None if _build.RECORDER is None else
                _build.RECORDER.loop("distributed.chunk_sorts", unrolled=True))
        pieces = []
        for s in range(held):
            row = []
            for c in range(num_chunks):
                if loop is not None:
                    loop.step()
                lo = s * n_local + c * chunk
                row.append(_sort_chunk(carrier[lo:lo + chunk],
                                       [v[lo:lo + chunk] for v in leaves],
                                       cfg, engine))
            pieces.append(row)
        if loop is not None:
            loop.close()
        del carrier

        def attempt(a):
            """One splitter selection + exchange round at refine^a
            density; per held shard the received (C, nshards, capacity)
            keys and leaves and (C, nshards) counts, and the replicated
            overflow flag."""
            s_a = oversample * (refine ** a)
            m = max(1, min(-(-s_a // num_chunks), chunk))
            ranks = _even_sample_ranks(chunk, m, dev)
            splitters = _make_splitters(
                [_local_sample(row, ranks) for row in pieces], mesh)
            rks, rls, rcs, ovs = ([[] for _ in range(held)]
                                  for _ in range(4))
            for c in range(num_chunks):
                keys_c = [row[c][0] for row in pieces]
                dests = [_dest_shards(k, splitters, nshards, my)
                         for k, my in zip(keys_c, mesh.shards)]
                got = _exchange(keys_c, [row[c][1] for row in pieces],
                                dests, nshards, capacity, mesh, engine)
                for s in range(held):
                    for lst, val in zip((rks, rls, rcs, ovs), got):
                        lst[s].append(val[s])
            over = mesh.any([functools.reduce(torch.logical_or, ov)
                             for ov in ovs])
            return ([torch.stack(r) for r in rks],
                    [tuple(torch.stack(ls) for ls in zip(*r)) for r in rls],
                    [torch.stack(r) for r in rcs], over)

        carry = attempt(0)
        attempts = 1
        while attempts < max_attempts and _read(carry[3]):
            carry = attempt(attempts)
            attempts += 1
        rks, rls, rcs, over = carry
        del pieces

        # the finish: one merge over all C · nshards received runs, then
        # the 2-bucket compaction of the valid keys
        out_k, out_l = [], []
        for s in range(held):
            merged, midx = _merge_runs(rks[s].reshape(-1, capacity))
            k, ls = _compact(merged, midx, rls[s], rcs[s], capacity, engine)
            out_k.append(k)
            out_l.append(ls)
            rks[s] = rls[s] = None
        stats = DistStats(
            exchange_attempts=torch.full((held,), attempts, dtype=_I32,
                                         device=dev),
            overflow=over.reshape(1).expand(held).clone(),
            valid=torch.stack([c.sum() for c in rcs]).to(_I32),
            peak_recv=torch.stack([c.max() for c in rcs]).to(_I32))
        return (torch.cat(out_k),
                [torch.cat(ls) for ls in zip(*out_l)] if leaves else [],
                stats)

    def fn(keys, values: Any = None):
        keys = _to_mesh(keys, mesh, "keys")
        if keys.dim() != 1:
            raise ValueError("the distributed sort expects 1-D keys")
        leaves, treedef = interop.tree_flatten(values if values is not None
                                               else ())
        leaves = [_to_mesh(v, mesh, "values") for v in leaves]
        for leaf in leaves:
            if leaf.shape[0] != keys.shape[0]:
                raise ValueError(
                    f"payload leaf length {leaf.shape[0]} != keys length "
                    f"{keys.shape[0]}")
        dtypes = [v.dtype for v in leaves]
        # torch cannot scatter or gather uint16/32/64: move the signed twins
        moved = [v.view(_MOVABLE.get(v.dtype, v.dtype)) for v in leaves]
        out_c, out_leaves, stats = dsort(keys, moved)
        out_keys = bijection.from_ordered_bits(out_c, keys.dtype)
        if values is None:
            return out_keys, stats
        out_leaves = [v.view(dt) for v, dt in zip(out_leaves, dtypes)]
        return out_keys, interop.tree_unflatten(treedef, out_leaves), stats

    return fn


def valid_concat(out, valid):
    """Concatenate the valid prefixes of every shard's padded output (keys
    or any payload leaf) into the global sorted sequence.  Numpy in, numpy
    out (host-side, as the reference's); a tensor stays on its device."""
    if isinstance(valid, torch.Tensor):
        valid = valid.tolist()
    valid = [int(v) for v in np.asarray(valid).reshape(-1)]
    if isinstance(out, torch.Tensor):
        per = out.reshape(len(valid), -1)
        return torch.cat([per[i, :v] for i, v in enumerate(valid)])
    per = np.asarray(out).reshape(len(valid), -1)
    return np.concatenate([per[i][:v] for i, v in enumerate(valid)])


# --- contract declaration (verified by repro_torch.analysis; see
# analysis/contracts)
# Shard-body census: per chunk one full hybrid sort, per cond-guarded attempt
# per chunk one bucketing counting pass (2 sites), plus the 2-bucket validity
# compaction.  Link bytes re-derive the ICI table of kernels/__init__ from
# the collective-primitive result shapes: per attempt per chunk one keys +
# ``leaves`` payload + one counts all_to_all at capacity padding, per attempt
# one splitter-sample all_gather (samp lists the gathered per-shard sample
# lengths) and one scalar overflow psum.
ANALYSIS_CONTRACT = {
    "entry": "repro_torch.core.distributed.make_distributed_sort",
    "census": {
        "launch_total": "chunks * (2 + classes)"
                        " + 2 * attempts * chunks + 2",
        "while_body_launches": "[1] * chunks",
    },
    "sort_free": True,
    "link": {
        "collective_counts": {
            "all_to_all": "attempts * chunks * (2 + leaves)",
            "all_gather": "attempts",
            "psum": "attempts",
        },
        "link_bytes": "((P - 1) / P) * ("
                      "attempts * chunks * P * (cap * (kb + vb) + 4)"
                      " + kb * P * sum(samp) + attempts * 2 * 4)",
    },
}
