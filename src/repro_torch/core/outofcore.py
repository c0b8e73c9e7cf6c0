"""Out-of-core pipelined sort (paper §5): port of ``repro.core.outofcore``.

The host array (or chunk stream) is cut into device-sized chunks; every
chunk is uploaded and sorted on the card while the next chunk's upload is
in flight, and the sorted runs are merged by rounds of the merge-path
kernel (``kernels.merge.kway_merge_round``, ``csrc/merge.cu``), one launch
per round.  Two device-memory regimes, as in the reference:

  * **device-resident** (default): the runs are concatenated into one flat
    ping-pong pair on the card and merged in ⌈log_K(runs)⌉ rounds;
  * **host-spill** (``spill_budget_bytes`` / ``device_slab_elems``): runs
    live host-side between rounds, every multi-run group is cut into
    slab-sized strips (``kernels.merge.spill_group_plan``) and each strip is
    one upload, ONE merge launch and one download, so device memory stays
    bounded by the slab budget.

Faults, retries, the degradation ladder (slab, then kway, then re-chunk),
host checksums, round checkpoints and resume are the reference's, call for
call: the seven guarded sites of ``core.faults`` are visited in the same
order and the same number of times, the device-byte ledger makes the same
allocations, and the link bytes keep the identity ``h2d + d2h ==
chunk_link + spill_link + retry_link`` — so a ``FaultPolicy`` of a given
seed gives equal ``OocStats`` in both packages.

Host-device crossings (the ``_Link`` below).  JAX's asynchronous
``device_put`` becomes, on a CUDA device, a copy stream fed by one worker
thread through two pinned staging buffers: the worker copies a piece of the
numpy array into pinned memory while the previous piece crosses the link
(``non_blocking=True``), and records an event when the whole array is
across.  The sort stream waits on that event before it reads the chunk, so
chunk i+1's upload — host copy and link transfer — runs while chunk i
sorts.  Downloads go the same way in reverse, and a run's (or a strip's)
download is queued as soon as its sort (or merge) is queued, so it crosses
while the next one runs.  On the CPU every crossing is a plain copy.

Host runs are numpy arrays in the reference's unsigned ordered bits, value
leaves in their own dtypes; on the device, keys are the port's signed
carrier and unsigned value leaves travel as their signed twins (PyTorch
has no gather or scatter for uint32 / uint64).
"""
from __future__ import annotations

import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import bijection, interop, model
from repro_torch.core.faults import (ChecksumError, FaultLedger, FaultPolicy,
                                     RetriesExhausted, RetryPolicy, guarded,
                                     tree_checksums)
from repro_torch.core.hybrid import hybrid_sort
from repro_torch.core.ranks import resolve_engine
from repro_torch.kernels import merge as kmerge
from repro_torch.kernels.fused import pad_length

# Modeled peak device working set, in units of one chunk / one slab payload
# (the reference's constants; see its module for the derivation).
_CHUNK_FOOTPRINT = 12
_SLAB_FOOTPRINT = 10


def _chunk_working_bytes(chunk_elems: int, elem_bytes: int, cfg, engine,
                         key_dtype, device) -> int:
    """Modeled device working set of one chunk sort (its ping-pong pair).

    The kernel engine's ping-pong buffers are ``pad_length(n, kpb)`` long;
    the plain engines work in n-sized buffers.  The engine is resolved on
    the device the chunks sort on: ``auto`` is the kernel engine on CUDA.
    """
    if resolve_engine(engine, device) == "kernel":
        kpb = (cfg or model.default_config(
            bijection.key_bits(key_dtype) // 8)).kpb
        return 2 * pad_length(chunk_elems, kpb) * elem_bytes
    return 2 * chunk_elems * elem_bytes


def _chunk_peak_bytes(chunk_elems: int, elem_bytes: int, cfg, engine,
                      key_dtype, device) -> int:
    """Modeled chunk-phase peak: staged chunks i-1/i/i+1, sorted runs i-1/i,
    and two sort working sets in flight (the spill pipeline's worst case)."""
    return 5 * chunk_elems * elem_bytes + 2 * _chunk_working_bytes(
        chunk_elems, elem_bytes, cfg, engine, key_dtype, device)


def _spill_peak_bytes(slab: int, tile: int, elem_bytes: int,
                      kway: int) -> int:
    """Modeled worst-case live device bytes of the strip stream: six padded
    slabs, strip i+1's exact upload and three strips' table sets."""
    bufsize = slab + tile                       # pad_length for tile-aligned
    g = slab // tile
    table_bytes = (2 * g + 2 * g * kway) * np.dtype(np.int32).itemsize
    return (6 * bufsize + slab) * elem_bytes + 3 * table_bytes


class OocStats(NamedTuple):
    num_chunks: int      # sorted device runs the input was split into
    merge_rounds: int    # merge-kernel rounds executed (this process)
    chunk_elems: int     # device chunk capacity the plan used (post-ladder)
    h2d_bytes: int       # host->device payload bytes (incl. failed attempts)
    d2h_bytes: int       # device->host payload bytes (incl. failed attempts)
    device_high_water_bytes: int = 0   # modeled peak device bytes (ledger)
    chunk_link_bytes: int = 0   # chunk-phase crossings: 2·N·(b+v)
    spill_link_bytes: int = 0   # spill-round crossings: +2·N·(b+v) per round
    rounds_spilled: int = 0     # rounds streamed through host-side runs
    spill_slab_elems: int = 0   # device slab capacity (0: device-resident)
    retries: int = 0            # guarded ops re-attempted after a fault
    faults_injected: int = 0    # faults the FaultPolicy fired (all kinds)
    degradations: int = 0       # ladder rungs walked (slab/kway/re-chunk)
    checksum_failures: int = 0  # host-buffer corruptions detected
    rounds_checkpointed: int = 0  # merge rounds published to the store
    retry_link_bytes: int = 0   # extra link bytes of failed/aborted attempts
    chunk_passes_executed: int = 0  # counting passes the chunk sorts ran
                                    # (0 on resumed runs)


class _DeviceLedger:
    """Host-side model of live device bytes (the high-water gate).

    Charges what the reference's oocsort charges, call for call; the real
    allocator peak on the card is measured separately
    (``torch.cuda.max_memory_allocated``).
    """

    def __init__(self):
        self.live = 0
        self.high = 0

    def alloc(self, nbytes: int) -> None:
        self.live += int(nbytes)
        self.high = max(self.high, self.live)

    def free(self, nbytes: int) -> None:
        self.live -= int(nbytes)


# --------------------- host <-> device crossings ----------------------------

def _signed(a: np.ndarray) -> np.ndarray:
    """A contiguous numpy array, unsigned integers viewed as the signed
    twin (torch has no gather or scatter for uint32 / uint64, and the
    device carrier is signed)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "u":
        return a.view(np.dtype(f"i{a.dtype.itemsize}"))
    return a


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    with warnings.catch_warnings():     # read-only inputs are only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(_signed(a))


def _twin(dt) -> torch.dtype:
    """The torch dtype a numpy dtype travels as (signed twin if unsigned)."""
    return _host_tensor(np.zeros(0, dt)).dtype


def _key_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy key dtype itself (uint32 stays uint32)."""
    return torch.from_numpy(np.zeros(0, dt)).dtype


class _Pending:
    """An upload or download in flight; ``result()`` waits for it.

    For an upload it makes the current (compute) stream wait on the copy's
    event and returns the device tensors; for a download it returns the
    filled numpy arrays.  Calling it again returns the same value.
    """

    def __init__(self, value=None, future=None, device=None):
        self._value = value
        self._future = future
        self._device = device

    def result(self):
        if self._future is None:
            return self._value
        event = self._future.result()
        if event is not None:
            torch.cuda.current_stream(self._device).wait_event(event)
        return self._value


class _Link:
    """Host <-> device copies of one ``oocsort`` call (see the module note).

    ``upload(pairs)`` and ``download(pairs)`` take ``(source, destination)``
    pairs of a numpy array and a device tensor of the same bytes.  The
    destination (upload) or source (download) is allocated by the caller on
    the compute stream; the copy stream waits for the compute stream first.
    """

    #: bytes per staged piece; two pinned buffers of this size
    PIECE = 64 << 20

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = ThreadPoolExecutor(1, thread_name_prefix="ooc-link")
            self.pinned = [torch.empty(self.PIECE, dtype=torch.uint8,
                                       pin_memory=True) for _ in range(2)]
            self.busy = [None, None]            # last event on each buffer
            self.turn = 0
            self.futures = []

    def close(self) -> None:
        """Wait for every copy; raise the first copy that failed (an
        aborted attempt may have left its result unread)."""
        if self.cuda:
            self.pool.shutdown(wait=True)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            for f in self.futures:
                f.result()

    # -- worker side ------------------------------------------------------

    def _buffer(self):
        i = self.turn
        self.turn ^= 1
        if self.busy[i] is not None:
            self.busy[i].synchronize()
        return i

    def _upload(self, ready, pairs):
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            for src, dst in pairs:
                s = _host_tensor(src).reshape(-1).view(torch.uint8)
                d = dst.view(torch.uint8)
                for off in range(0, s.numel(), self.PIECE):
                    m = min(self.PIECE, s.numel() - off)
                    i = self._buffer()
                    buf = self.pinned[i][:m]
                    buf.copy_(s[off:off + m])
                    d[off:off + m].copy_(buf, non_blocking=True)
                    self.busy[i] = torch.cuda.Event()
                    self.busy[i].record(self.stream)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done

    def _download(self, ready, pairs):
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            held = None                          # (buffer, host slice)

            def drain():
                i, out = held
                self.busy[i].synchronize()
                out.copy_(self.pinned[i][:out.numel()])

            for src, dst in pairs:
                s = src.view(torch.uint8)
                d = _host_tensor(dst).reshape(-1).view(torch.uint8)
                for off in range(0, s.numel(), self.PIECE):
                    m = min(self.PIECE, s.numel() - off)
                    i = self._buffer()
                    self.pinned[i][:m].copy_(s[off:off + m], non_blocking=True)
                    self.busy[i] = torch.cuda.Event()
                    self.busy[i].record(self.stream)
                    if held is not None:
                        drain()
                    held = (i, d[off:off + m])
            if held is not None:
                drain()
        return None

    # -- compute side -----------------------------------------------------

    def _ready(self, tensors):
        for t in tensors:
            t.record_stream(self.stream)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return ready

    def _submit(self, fn, tensors, pairs, value) -> _Pending:
        future = self.pool.submit(fn, self._ready(tensors), pairs)
        self.futures.append(future)
        return _Pending(value, future, self.device)

    def upload(self, pairs, value=None) -> _Pending:
        pairs = [(src, dst) for src, dst in pairs if dst.numel()]
        if not self.cuda:
            for src, dst in pairs:
                dst.copy_(_host_tensor(src).reshape(-1))
            return _Pending(value)
        return self._submit(self._upload, [dst for _, dst in pairs], pairs,
                            value)

    def download(self, pairs, value=None) -> _Pending:
        pairs = [(src, dst) for src, dst in pairs if src.numel()]
        if not self.cuda:
            for src, dst in pairs:
                _host_tensor(dst).reshape(-1).copy_(src)
            return _Pending(value)
        return self._submit(self._download, [src for src, _ in pairs], pairs,
                            value)

    def put(self, arrays) -> _Pending:
        """Upload whole numpy arrays into new device tensors (their signed
        twins); ``result()`` gives the tensors as a tuple."""
        tensors = tuple(torch.empty(a.shape[0], dtype=_twin(a.dtype),
                                    device=self.device) for a in arrays)
        return self.upload(list(zip(arrays, tensors)), tensors)

    def get(self, tensors, dtypes) -> _Pending:
        """Download 1-D device tensors into new numpy arrays of ``dtypes``
        (same item sizes); ``result()`` gives the arrays as a tuple."""
        arrays = tuple(np.empty(t.shape[0], dt) for t, dt in
                       zip(tensors, dtypes))
        return self.download(list(zip(tensors, arrays)), arrays)


# --------------------- input normalisation ----------------------------------

_NO_VALUES = ("no values",)


def _flatten(vals):
    if vals is None:
        return [], _NO_VALUES
    return interop.tree_flatten(vals)


def _as_stream(reader, values):
    """Normalise the input to a stream of (keys, values-or-None) pieces."""
    if hasattr(reader, "shape") and hasattr(reader, "dtype"):
        yield reader, values
        return
    if values is not None:
        raise ValueError("with an iterator reader, pass values inline as "
                         "(keys, values) tuples")
    for item in reader:
        if isinstance(item, tuple):
            yield item
        else:
            yield item, None


def _rechunk(stream, chunk_elems: int):
    """Re-cut a stream of (keys, values) pieces into device-sized chunks.

    Returns ``(chunks, treedef, key_dtype, empty_leaves)``; each chunk is
    ``(keys, value_leaves)`` of numpy arrays with ``len(keys) <=
    chunk_elems``.  Validation errors name the offending input chunk.
    """
    buf_k, buf_v = [], []
    chunks = []
    treedef = None
    key_dtype = None
    empty_leaves = ()
    pending = 0

    def emit(upto):
        nonlocal buf_k, buf_v, pending
        k = np.concatenate(buf_k) if len(buf_k) > 1 else buf_k[0]
        vs = [np.concatenate(c) if len(c) > 1 else c[0] for c in buf_v]
        chunks.append((k[:upto], tuple(v[:upto] for v in vs)))
        buf_k = [k[upto:]] if upto < k.shape[0] else []
        buf_v = [[v[upto:]] for v in vs] if upto < k.shape[0] else \
            [[] for _ in vs]
        pending -= upto

    for ci, (keys, vals) in enumerate(stream):
        keys = np.asarray(keys)
        if keys.ndim != 1:
            raise ValueError(f"chunk {ci}: oocsort expects 1-D key chunks")
        leaves, td = _flatten(vals)
        leaves = [np.asarray(v) for v in leaves]
        if key_dtype is None:
            treedef, key_dtype = td, keys.dtype
            empty_leaves = tuple(v[:0] for v in leaves)
            buf_v = [[] for _ in leaves]
        elif td != treedef:
            raise ValueError(f"chunk {ci}: inconsistent value structure "
                             f"across chunks ({td} vs {treedef})")
        if keys.dtype != key_dtype:
            raise ValueError(f"chunk {ci}: inconsistent key dtype across "
                             f"chunks: {keys.dtype} vs {key_dtype}")
        if any(v.dtype != p.dtype for v, p in zip(leaves, empty_leaves)):
            raise ValueError(f"chunk {ci}: inconsistent value dtypes across "
                             f"chunks")
        if any(v.ndim != 1 for v in leaves):
            raise ValueError(f"chunk {ci}: oocsort value leaves must be 1-D "
                             f"(the merge kernel moves flat per-key slabs)")
        if any(v.shape[0] != keys.shape[0] for v in leaves):
            raise ValueError(f"chunk {ci}: value leaves must match the key "
                             f"length")
        if keys.shape[0] == 0:
            continue
        buf_k.append(keys)
        for c, v in zip(buf_v, leaves):
            c.append(v)
        pending += keys.shape[0]
        while pending >= chunk_elems:
            emit(chunk_elems)
    if pending:
        emit(pending)
    return chunks, treedef, key_dtype, empty_leaves


def _split_chunks(chunks, chunk_elems: int):
    """Re-split host chunks to a smaller capacity (budget clamp / ladder)."""
    out = []
    for k, vs in chunks:
        for o in range(0, k.shape[0], chunk_elems):
            out.append((k[o:o + chunk_elems],
                        tuple(v[o:o + chunk_elems] for v in vs)))
    return out


def _chunk_nbytes(chunk) -> int:
    return chunk[0].nbytes + sum(v.nbytes for v in chunk[1])


# --------------------- the two device steps ---------------------------------

def _sort_chunk(keys, leaves, cfg, engine):
    """Sort one staged chunk; emit the run as the ordered-bits carrier.

    ``keys`` is the chunk in its key dtype, ``leaves`` its value leaves.
    The third element is the executed counting-pass count of the sort.
    The reference sorts chunks under ``jit``, where keys are traced and the
    adaptive schedule starts from the full key width, hence
    ``narrow=False``.
    """
    if leaves:
        sk, sv, st = hybrid_sort(keys, tuple(leaves), cfg=cfg, engine=engine,
                                 return_stats=True, narrow=False)
        sv = tuple(sv)
    else:
        sk, st = hybrid_sort(keys, cfg=cfg, engine=engine, return_stats=True,
                             narrow=False)
        sv = ()
    return bijection.to_ordered_bits(sk), sv, st.counting_passes


def merge_round(src_keys, src_vals, alt_keys, alt_vals, *, lens, kway: int,
                tile: int, n: int):
    """One k-way merge round: the merge-path partition of the current runs
    (binary searches on the device) and ONE merge-kernel launch.  ``lens``
    are the current run lengths; the alternate buffers are written."""
    tables = kmerge.merge_path_partition(src_keys, lens, kway, tile)
    return kmerge.kway_merge_round(src_keys, src_vals, alt_keys, alt_vals,
                                   *tables, kway=kway, tpb=tile, n=n)


class _Job(NamedTuple):
    """One slab strip of one merge group, with its host source/target runs."""
    strip: kmerge.SpillStrip
    kruns: list           # host key runs of the group (np, unsigned bits)
    vruns: list           # host value runs: per run a tuple of leaves
    mk: np.ndarray        # merged host key run being assembled
    mv: Tuple[np.ndarray, ...]


class _RechunkEscalation(Exception):
    """The merge ladder's last rung: restart the pipeline with smaller
    chunks (carries the :class:`RetriesExhausted` to re-raise when
    re-chunking is impossible)."""

    def __init__(self, cause: RetriesExhausted):
        super().__init__(str(cause))
        self.cause = cause


def _verify_runs(keys_h, vals_h, checksums) -> None:
    """Verify every host run against its recorded checksums (pre-consume)."""
    for i, (k, vs) in enumerate(zip(keys_h, vals_h)):
        if tree_checksums((k,) + tuple(vs)) != tuple(checksums[i]):
            raise ChecksumError(
                f"host run {i} no longer matches its recorded checksum "
                f"(corrupted while host-resident or in transit)")


def _run_checksums(keys_h, vals_h):
    return [tree_checksums((k,) + tuple(vs))
            for k, vs in zip(keys_h, vals_h)]


def _flat_run_arrays(keys_h, vals_h):
    out = list(keys_h)
    for vs in vals_h:
        out.extend(vs)
    return out


# --------------------- round-granular checkpointing -------------------------

def _save_round_checkpoint(directory: str, round_idx: int, keys_h, vals_h,
                           checksums, meta: dict, keep: int = 3) -> None:
    """Publish one merge round atomically via ``checkpoint.store``: run key
    buffers ``k####``, value leaves ``v####_#`` and a JSON ``meta`` leaf."""
    meta = dict(meta, round=round_idx,
                run_lens=[int(k.shape[0]) for k in keys_h],
                checksums=[list(cs) for cs in checksums])
    tree = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    for i, k in enumerate(keys_h):
        tree[f"k{i:04d}"] = k
        for j, v in enumerate(vals_h[i]):
            tree[f"v{i:04d}_{j}"] = v
    store.save_checkpoint(directory, round_idx, tree, keep=keep)


def _load_round_checkpoint(directory: str, round_idx: Optional[int] = None):
    """Load the newest (or a specific) checkpointed round: ``(meta, keys_h,
    vals_h)`` as writable host arrays, checksums re-verified."""
    if round_idx is None:
        round_idx = store.latest_step(directory)
        if round_idx is None:
            raise ValueError(f"resume_from={directory!r}: no checkpointed "
                             f"rounds found")
    flat = {p[2:-2]: a
            for p, a in store.restore_blind(directory, round_idx).items()}
    meta = json.loads(bytes(flat.pop("meta")))
    nruns = len(meta["run_lens"])
    nleaves = meta["num_leaves"]
    keys_h = [np.array(flat[f"k{i:04d}"]) for i in range(nruns)]
    vals_h = [tuple(np.array(flat[f"v{i:04d}_{j}"]) for j in range(nleaves))
              for i in range(nruns)]
    _verify_runs(keys_h, vals_h, meta["checksums"])
    return meta, keys_h, vals_h


# --------------------- chunk phase ------------------------------------------

def _chunk_phase(chunks, *, spill, cfg, engine, key_dtype, leaf_dtypes,
                 elem_bytes, ledger, faults, retry, faultlog, acct, link):
    """Double-buffered chunk uploads + sorts, §5's upload/sort overlap.

    Every upload goes through the ``chunk_upload`` fault site, every sort
    through ``sort_launch`` and (spill regime) every run download through
    ``run_download``.  Chunk i+1's upload is queued before chunk i's sort;
    in the spill regime run i's download is queued right after its sort and
    collected after sort i+1.  Returns ``(runs, passes)``: device runs
    ``(carrier, leaves)``, or host numpy pairs in the spill regime, and the
    per-chunk executed pass counts.
    """
    num_chunks = len(chunks)
    udtype = bijection.to_ordered_bits_np(np.zeros(0, key_dtype)).dtype
    kdt = _key_dtype(key_dtype) if np.dtype(key_dtype).kind == "u" \
        else None

    def upload(chunk, nbytes):
        out = guarded("chunk_upload", link.put, (chunk[0],) + chunk[1],
                      policy=faults, retry=retry, ledger=faultlog,
                      cost_bytes=nbytes, direction="h2d")
        ledger.alloc(nbytes)
        acct["up"] += nbytes
        return out

    def sort(staged):
        keys, *leaves = staged.result()
        if kdt is not None:             # the signed twin back to unsigned
            keys = keys.view(kdt)
        return _sort_chunk(keys, tuple(leaves), cfg, engine)

    def land(p):
        handle, nbytes, held = p
        out = guarded("run_download", handle.result, policy=faults,
                      retry=retry, ledger=faultlog, cost_bytes=nbytes,
                      direction="d2h")
        acct["down"] += nbytes
        ledger.free(held)
        return out[0], out[1:]

    staged_bytes = _chunk_nbytes(chunks[0])
    staged = upload(chunks[0], staged_bytes)
    runs = []
    passes = []
    pending = None     # spill: (download handle, run bytes, working bytes)
    for i in range(num_chunks):
        nxt = nxt_bytes = None
        if i + 1 < num_chunks:
            nxt_bytes = _chunk_nbytes(chunks[i + 1])
            nxt = upload(chunks[i + 1], nxt_bytes)       # stage i+1 ...
        ws = _chunk_working_bytes(chunks[i][0].shape[0], elem_bytes, cfg,
                                  engine, key_dtype, link.device)
        ledger.alloc(ws)                                 # sort ping-pong model
        run = guarded("sort_launch", sort, staged, policy=faults,
                      retry=retry, ledger=faultlog)      # ... sort i
        passes.append(run[2])
        run = run[:2]
        ledger.alloc(staged_bytes)                       # the sorted run
        if spill:
            handle = link.get((run[0],) + run[1], (udtype,) + leaf_dtypes)
            if pending is not None:                      # ... land run i-1
                runs.append(land(pending))
            pending = (handle, staged_bytes, 2 * staged_bytes + ws)
        else:
            runs.append(run)
            ledger.free(staged_bytes + ws)               # staged + working set
        staged, staged_bytes = nxt, nxt_bytes
    if spill:
        runs.append(land(pending))
    return runs, passes


# --------------------- host-spill streaming merge ---------------------------

def _spill_round(keys_h, vals_h, *, kway: int, tile: int, slab: int,
                 ledger: _DeviceLedger, faults, retry, faultlog: FaultLedger,
                 elem_bytes: int, acct: dict, link: _Link):
    """ONE host-spilled merge round: stream every group through device slabs.

    Strip i+1's upload is queued before strip i's merge launch, and strip
    i's download right after it, so the copies run while the next strip
    merges; single-run leftovers carry over host-side for free.  Strip
    uploads, merge launches and strip downloads are guarded fault sites.
    Returns the next round's ``(keys, values)`` host run lists.
    """
    udtype = keys_h[0].dtype
    bufsize = pad_length(slab, tile)
    dev = link.device
    kdt = _twin(udtype)
    ldts = [_twin(v.dtype) for v in vals_h[0]]

    next_k, next_v, jobs = [], [], []
    for grp in kmerge.merge_groups(list(range(len(keys_h))), kway):
        if len(grp) == 1:               # leftover run: carried for free
            next_k.append(keys_h[grp[0]])
            next_v.append(vals_h[grp[0]])
            continue
        kruns = [keys_h[j] for j in grp]
        vruns = [vals_h[j] for j in grp]
        glen = sum(r.shape[0] for r in kruns)
        mk = np.empty(glen, udtype)
        mv = tuple(np.empty(glen, v.dtype) for v in vruns[0])
        next_k.append(mk)
        next_v.append(mv)
        for strip in kmerge.spill_group_plan(kruns, kway, tile, slab):
            jobs.append(_Job(strip, kruns, vruns, mk, mv))

    def stage(job):
        strip, kruns, vruns = job.strip, job.kruns, job.vruns
        k = len(kruns)
        seg = np.concatenate([[0], np.cumsum(strip.win_len)])
        wins = [slice(strip.win_lo[r], strip.win_lo[r] + strip.win_len[r])
                for r in range(k)]
        up_bytes = strip.out_len * elem_bytes

        def upload():
            # the windows land back to back in a slab-sized buffer; the
            # merge reads nothing after them as live data
            slab_k = torch.empty(bufsize, dtype=kdt, device=dev)
            slab_v = tuple(torch.empty(bufsize, dtype=dt, device=dev)
                           for dt in ldts)
            tabs = tuple(torch.empty(t.shape[0], dtype=torch.int32,
                                     device=dev) for t in strip.tables)
            pairs = list(zip(strip.tables, tabs))
            for r in range(k):
                dst = slice(int(seg[r]), int(seg[r + 1]))
                pairs.append((kruns[r][wins[r]], slab_k[dst]))
                pairs += [(vruns[r][li][wins[r]], v[dst])
                          for li, v in enumerate(slab_v)]
            return link.upload(pairs, (slab_k, slab_v, tabs))

        handle = guarded("slab_upload", upload, policy=faults, retry=retry,
                         ledger=faultlog, cost_bytes=up_bytes,
                         direction="h2d")
        ledger.alloc(up_bytes)
        acct["up"] += up_bytes
        tab_bytes = sum(t.nbytes for t in strip.tables)
        ledger.alloc(tab_bytes)
        slab_bytes = bufsize * elem_bytes
        ledger.alloc(slab_bytes)
        ledger.free(up_bytes)
        return handle, slab_bytes + tab_bytes

    def launch(staged, job):
        handle, held = staged

        def fire():
            slab_k, slab_v, tabs = handle.result()
            alt_k = torch.empty_like(slab_k)
            alt_v = tuple(torch.empty_like(v) for v in slab_v)
            return kmerge.kway_merge_round(
                slab_k, slab_v, alt_k, alt_v, *tabs, kway=kway, tpb=tile,
                n=slab), bufsize * elem_bytes

        (out_k, out_v), alt_bytes = guarded(
            "merge_launch", fire, policy=faults, retry=retry, ledger=faultlog)
        ledger.alloc(alt_bytes)
        lo, sl = job.strip.out_lo, job.strip.out_len
        pairs = [(out_k[:sl], job.mk[lo:lo + sl])]
        pairs += [(v[:sl], m[lo:lo + sl]) for v, m in zip(out_v, job.mv)]
        return link.download(pairs), held + alt_bytes

    def collect(launched, job):
        handle, held = launched
        guarded("slab_download", handle.result, policy=faults, retry=retry,
                ledger=faultlog, cost_bytes=job.strip.out_len * elem_bytes,
                direction="d2h")
        acct["down"] += job.strip.out_len * elem_bytes
        ledger.free(held)

    staged = stage(jobs[0])
    prev = None
    for i, job in enumerate(jobs):
        nxt = stage(jobs[i + 1]) if i + 1 < len(jobs) else None      # up i+1
        launched = launch(staged, job)                               # run i
        if prev is not None:
            collect(*prev)                                           # down i-1
        prev = (launched, job)
        staged = nxt
    collect(*prev)
    return next_k, next_v


def _merge_spilled(keys_h, vals_h, *, round_idx: int, kway: int, tile: int,
                   slab: int, budget: Optional[int], elem_bytes: int,
                   ledger: _DeviceLedger, faults, retry,
                   faultlog: FaultLedger, checkpoint_dir: Optional[str],
                   checkpoint_every: int, meta_base: dict, link: _Link,
                   checksums=None, save_incoming: bool = True,
                   checksummed: bool = True):
    """The spill merge's round loop: verify → merge → checksum → checkpoint.

    Owns the merge half of the degradation ladder (slab halving to the
    ``tile`` floor, then kway halving to 2; the re-chunk rung escalates via
    :class:`_RechunkEscalation`) and the recovery from detected host
    corruption (restore the last published round and continue).  Returns
    ``(keys, vals, rounds_done, up, down, kway, slab)``.
    """
    up_total = down_total = 0
    rounds_done = 0
    if checksums is None and checksummed:
        checksums = _run_checksums(keys_h, vals_h)
    last_ckpt = None

    def save(idx):
        nonlocal last_ckpt
        _save_round_checkpoint(
            checkpoint_dir, idx, keys_h, vals_h, checksums,
            dict(meta_base, kway=kway, tile=tile, slab=slab,
                 fault_state=faults.state() if faults is not None else {}))
        faultlog.rounds_checkpointed += 1
        last_ckpt = idx

    if checkpoint_dir is not None:
        if save_incoming:
            save(round_idx)        # round-0 / adopted-state checkpoint
        else:
            last_ckpt = round_idx  # resumed from this very round
    if faults is not None and len(keys_h) > 1:
        faults.maybe_corrupt(_flat_run_arrays(keys_h, vals_h))

    while len(keys_h) > 1:
        live0 = ledger.live
        acct = {"up": 0, "down": 0}
        try:
            if checksummed:
                _verify_runs(keys_h, vals_h, checksums)
            nk, nv = _spill_round(
                keys_h, vals_h, kway=kway, tile=tile, slab=slab,
                ledger=ledger, faults=faults, retry=retry, faultlog=faultlog,
                elem_bytes=elem_bytes, acct=acct, link=link)
        except ChecksumError:
            faultlog.checksum_failures += 1
            ledger.live = live0
            faultlog.retry_h2d_bytes += acct["up"]
            faultlog.retry_d2h_bytes += acct["down"]
            if last_ckpt is None:
                raise
            meta, keys_h, vals_h = _load_round_checkpoint(
                checkpoint_dir, last_ckpt)
            checksums = [tuple(cs) for cs in meta["checksums"]]
            continue
        except RetriesExhausted as e:
            ledger.live = live0
            faultlog.retry_h2d_bytes += acct["up"]
            faultlog.retry_d2h_bytes += acct["down"]
            if slab > tile:                       # rung 1: halve the slab
                slab = max(tile, (slab // 2) - ((slab // 2) % tile))
                assert budget is None or _spill_peak_bytes(
                    slab, tile, elem_bytes, kway) <= budget
            elif kway > 2:                        # rung 2: halve the fan-in
                kway = max(2, kway // 2)
            else:                                 # rung 3: re-chunk smaller
                raise _RechunkEscalation(e)
            faultlog.degradations += 1
            continue
        up_total += acct["up"]
        down_total += acct["down"]
        keys_h, vals_h = nk, nv
        round_idx += 1
        rounds_done += 1
        if checksummed:
            checksums = _run_checksums(keys_h, vals_h)
        if checkpoint_dir is not None and len(keys_h) > 1 and \
                round_idx % checkpoint_every == 0:
            save(round_idx)
        if faults is not None and len(keys_h) > 1:
            faults.maybe_corrupt(_flat_run_arrays(keys_h, vals_h))
    return (keys_h[0], vals_h[0], rounds_done, up_total, down_total,
            kway, slab)


def _merge_resident(runs, lens, n, *, kway, tile, elem_bytes, ledger,
                    faults, retry, faultlog, device):
    """The device-resident merge: runs into one flat ping-pong pair of
    ``pad_length(n, tile)`` elements (the plain version's window loads and
    trash slot need the pad; nothing reads it as live data), then one
    guarded ``merge_round`` per round.  Returns ``(carrier, leaves,
    rounds)``."""
    n_pad = pad_length(n, tile)
    ck = torch.empty(n_pad, dtype=runs[0][0].dtype, device=device)
    cv = tuple(torch.empty(n_pad, dtype=v.dtype, device=device)
               for v in runs[0][1])
    at = 0
    for rk, rv in runs:
        m = rk.shape[0]
        ck[at:at + m] = rk
        for dst, src in zip(cv, rv):
            dst[at:at + m] = src
        at += m
    ledger.alloc(2 * n_pad * elem_bytes)        # flat ping-pong pair
    ledger.free(n * elem_bytes)                 # per-run buffers release
    runs.clear()
    ak = torch.empty_like(ck)
    av = tuple(torch.empty_like(v) for v in cv)
    mlens = list(lens)
    rounds = 0
    while len(mlens) > 1:
        nk, nv = guarded("merge_launch", merge_round, ck, cv, ak, av,
                         policy=faults, retry=retry, ledger=faultlog,
                         lens=tuple(mlens), kway=kway, tile=tile, n=n)
        ak, av = ck, cv              # old current is the next alternate
        ck, cv = nk, nv
        mlens = [sum(g) for g in kmerge.merge_groups(mlens, kway)]
        rounds += 1
    return ck, cv, rounds


def oocsort(reader, chunk_elems: int, values: Any = None,
            cfg: Optional[model.SortConfig] = None,
            engine: Optional[str] = None, kway: int = 4, tile: int = 256,
            return_stats: bool = False,
            spill_budget_bytes: Optional[int] = None,
            device_slab_elems: Optional[int] = None,
            faults: Optional[FaultPolicy] = None,
            retry: Optional[RetryPolicy] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1,
            resume_from: Optional[str] = None,
            values_like: Any = None,
            compress: bool = False,
            device=None):
    """Sort a host-resident array (or chunk stream) larger than one device run.

    The reference's signature and results, with ``interpret`` replaced by
    ``device``: the chunks sort and the runs merge on ``device`` — the GPU
    unless the caller passes ``"cpu"`` (where the kernel engine runs the
    kernels' plain versions); with no GPU and no ``device="cpu"`` this
    raises.

    ``reader`` is a 1-D numpy array, an iterable of 1-D key chunks, or an
    iterable of ``(keys, values)`` chunk tuples; ``values`` (array input
    only) is a 1-D array or a pytree of 1-D arrays permuted alongside.  The
    input is cut into runs of ``chunk_elems`` keys, each sorted by
    ``hybrid_sort`` (``cfg``/``engine`` as there) while the next chunk's
    upload is in flight, and the runs are merged by ⌈log_``kway``⌉ rounds
    of the merge kernel on output tiles of ``tile`` keys.

    ``spill_budget_bytes`` (a device-byte budget of the byte model)
    and/or ``device_slab_elems`` select the host-spill regime; the budget
    also clamps ``chunk_elems``.  ``faults``/``retry`` run every transfer
    and launch through fault injection and bounded retries, walking the
    degradation ladder on exhaustion; with any of ``faults``/``retry``/
    ``checkpoint_dir`` set, host runs are checksummed at each crossing.
    ``checkpoint_dir`` (spill regime) publishes the runs after every
    ``checkpoint_every``-th round; ``oocsort(None, 0, resume_from=dir)``
    replays from the newest round (``values_like`` restores the value
    structure).  Checkpoints are this package's own format (see
    ``checkpoint.store``).  ``compress=True`` packs the keys' live bits
    host-side before the first upload.

    Returns host numpy arrays: ``sorted_keys`` or ``(sorted_keys,
    permuted_values)``, plus an :class:`OocStats` when ``return_stats``.
    The port's sort is stable: equal keys keep their input order.
    """
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    device = interop.resolve_device(device)
    faultlog = FaultLedger()
    ledger = _DeviceLedger()
    link = _Link(device)
    try:
        if resume_from is not None:
            return _resume(resume_from, spill_budget_bytes=spill_budget_bytes,
                           faults=faults, retry=retry,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every,
                           values_like=values_like, return_stats=return_stats,
                           faultlog=faultlog, ledger=ledger, link=link)
        return _oocsort(reader, chunk_elems, values, cfg, engine, kway, tile,
                        return_stats, spill_budget_bytes, device_slab_elems,
                        faults, retry, checkpoint_dir, checkpoint_every,
                        compress, faultlog, ledger, link)
    finally:
        link.close()


def _oocsort(reader, chunk_elems, values, cfg, engine, kway, tile,
             return_stats, spill_budget_bytes, device_slab_elems, faults,
             retry, checkpoint_dir, checkpoint_every, compress, faultlog,
             ledger, link):
    device = link.device
    if chunk_elems < 1:
        raise ValueError("chunk_elems must be >= 1")
    if kway < 2:
        raise ValueError("kway must be >= 2")
    if tile < 8:
        raise ValueError("tile must be >= 8")
    spill = spill_budget_bytes is not None or device_slab_elems is not None
    if spill_budget_bytes is not None and spill_budget_bytes < 1:
        raise ValueError("spill_budget_bytes must be >= 1")
    if checkpoint_dir is not None and not spill:
        raise ValueError(
            "checkpoint_dir requires the host-spill regime (set "
            "spill_budget_bytes or device_slab_elems): round-granular "
            "checkpoints publish host-resident runs, which only exist there")

    chunks, treedef, key_dtype, empty_leaves = _rechunk(
        _as_stream(reader, values), chunk_elems)
    had_values = len(empty_leaves) > 0

    def finish(keys_np, leaves_np, stats):
        out = (keys_np,) if not had_values else \
            (keys_np, interop.tree_unflatten(treedef, list(leaves_np)))
        if return_stats:
            out = out + (stats,)
        return out[0] if len(out) == 1 else out

    if key_dtype is None:
        raise ValueError("empty iterator reader: yield at least one "
                         "(possibly empty) chunk to fix the dtype")

    # --- compressed-key mode: pack live bits host-side ---------------------
    orig_key_dtype = key_dtype
    cplan = None
    if compress and chunks:
        bits = bijection.key_bits(key_dtype)
        orv, andv = 0, (1 << bits) - 1
        for ckeys, _ in chunks:
            ub = bijection.to_ordered_bits_np(ckeys)
            if ub.size:
                orv |= int(np.bitwise_or.reduce(ub))
                andv &= int(np.bitwise_and.reduce(ub))
        mask = orv ^ andv
        cplan = bijection.CompressionPlan(mask=mask, dead=andv & ~mask,
                                          source_bits=bits)
        chunks = [(bijection.pack_ordered_bits_np(
                       bijection.to_ordered_bits_np(ckeys), cplan), vs)
                  for ckeys, vs in chunks]
        key_dtype = bijection.packed_carrier_dtype_np(cplan)

    def decode_np(ubits):
        if cplan is not None:
            ubits = bijection.unpack_ordered_bits_np(ubits, cplan)
        return bijection.from_ordered_bits_np(ubits, orig_key_dtype)

    # --- spill plan: slab capacity + chunk clamp from the device budget ----
    elem_bytes = np.dtype(key_dtype).itemsize + \
        sum(v.dtype.itemsize for v in empty_leaves)
    slab = 0
    if spill:
        slab = device_slab_elems
        if slab is not None:
            slab -= slab % tile
            if slab < tile:
                raise ValueError("device_slab_elems must be >= tile")
        if spill_budget_bytes is not None:
            if slab is None:
                slab = spill_budget_bytes // (_SLAB_FOOTPRINT * elem_bytes)
                slab -= slab % tile
            while slab >= tile and _spill_peak_bytes(
                    slab, tile, elem_bytes, kway) > spill_budget_bytes:
                slab -= tile
            if slab < tile:
                raise ValueError(
                    f"spill_budget_bytes={spill_budget_bytes} too small: "
                    f"need >= "
                    f"{_spill_peak_bytes(tile, tile, elem_bytes, kway)} "
                    f"for tile={tile} (worst-case stream of one-tile slabs)")
            # largest chunk whose engine-aware peak fits the budget
            peak = lambda c: _chunk_peak_bytes(c, elem_bytes, cfg, engine,
                                               key_dtype, device)
            if peak(1) > spill_budget_bytes:
                raise ValueError(
                    f"spill_budget_bytes={spill_budget_bytes} too small for "
                    f"the chunk phase: even a 1-element chunk sort models "
                    f"{peak(1)} device bytes (engine "
                    f"{resolve_engine(engine, device)!r}; the kernel engine "
                    f"pads to whole cfg.kpb tiles — pass a smaller-kpb cfg)")
            lo = 1
            hi = max(1, spill_budget_bytes // (_CHUNK_FOOTPRINT * elem_bytes))
            while peak(hi) <= spill_budget_bytes and hi < chunk_elems:
                hi = min(2 * hi, chunk_elems)
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if peak(mid) <= spill_budget_bytes \
                    else (lo, mid - 1)
            if lo < chunk_elems:
                chunk_elems = lo
                chunks = _split_chunks(chunks, chunk_elems)

    if not chunks:
        stats = OocStats(0, 0, chunk_elems, 0, 0,
                         spill_slab_elems=slab if spill else 0)
        return finish(np.empty((0,), key_dtype), empty_leaves, stats)

    n = sum(c[0].shape[0] for c in chunks)
    leaf_dtypes = tuple(v.dtype for v in empty_leaves)
    meta_base = {"key_dtype": np.dtype(key_dtype).str, "n": n,
                 "num_leaves": len(empty_leaves),
                 "value_dtypes": [v.dtype.str for v in empty_leaves]}
    if cplan is not None:
        meta_base["compress"] = {"mask": cplan.mask, "dead": cplan.dead,
                                 "source_bits": cplan.source_bits,
                                 "orig_dtype": np.dtype(orig_key_dtype).str}

    # --- attempt loop: the degradation ladder's restart point --------------
    while True:
        ledger.live = 0
        num_chunks = len(chunks)
        lens = [c[0].shape[0] for c in chunks]
        acct = {"up": 0, "down": 0}

        def _abort_attempt():
            ledger.live = 0
            faultlog.retry_h2d_bytes += acct["up"]
            faultlog.retry_d2h_bytes += acct["down"]

        def _rechunk_smaller():
            nonlocal chunk_elems, chunks
            if chunk_elems <= 1:
                return False
            chunk_elems = max(1, chunk_elems // 2)
            chunks = _split_chunks(chunks, chunk_elems)
            faultlog.degradations += 1
            return True

        # --- chunk phase: double-buffered staging --------------------------
        try:
            runs, cpasses = _chunk_phase(
                chunks, spill=spill, cfg=cfg, engine=engine,
                key_dtype=key_dtype, leaf_dtypes=leaf_dtypes,
                elem_bytes=elem_bytes, ledger=ledger, faults=faults,
                retry=retry, faultlog=faultlog, acct=acct, link=link)
        except RetriesExhausted:
            _abort_attempt()
            if not _rechunk_smaller():
                raise
            continue
        chunk_up, chunk_down = acct["up"], acct["down"]

        # --- merge phase ----------------------------------------------------
        rounds = 0
        spill_up = spill_down = 0
        if spill:
            meta = dict(meta_base, num_chunks=num_chunks,
                        chunk_elems=chunk_elems)
            try:
                if num_chunks == 1:
                    keys_h, vals_h = runs[0]
                else:
                    (keys_h, vals_h, rounds, spill_up, spill_down, kway,
                     slab) = _merge_spilled(
                        [r[0] for r in runs], [r[1] for r in runs],
                        round_idx=0, kway=kway, tile=tile, slab=slab,
                        budget=spill_budget_bytes, elem_bytes=elem_bytes,
                        ledger=ledger, faults=faults, retry=retry,
                        faultlog=faultlog, checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every, meta_base=meta,
                        link=link,
                        checksummed=(faults is not None or retry is not None
                                     or checkpoint_dir is not None))
            except _RechunkEscalation as esc:
                _abort_attempt()
                if not _rechunk_smaller():
                    raise esc.cause
                continue
            keys_np = decode_np(keys_h)
            leaves_np = tuple(vals_h)
        else:
            try:
                if num_chunks == 1:
                    ck, cv = runs[0]     # single run: no marshalling/merge
                else:
                    ck, cv, rounds = _merge_resident(
                        runs, lens, n, kway=kway, tile=tile,
                        elem_bytes=elem_bytes, ledger=ledger, faults=faults,
                        retry=retry, faultlog=faultlog, device=device)

                def gather():
                    kt = ck[:n]
                    if cplan is None:     # decode on the device
                        kt = bijection.from_ordered_bits(
                            kt, _key_dtype(key_dtype)).view(_twin(key_dtype))
                    out = link.get((kt,) + tuple(v[:n] for v in cv),
                                   (np.dtype(key_dtype),) +
                                   leaf_dtypes).result()
                    kn = out[0] if cplan is None else decode_np(out[0])
                    return kn, out[1:]

                keys_np, leaves_np = guarded(
                    "run_download", gather, policy=faults, retry=retry,
                    ledger=faultlog, cost_bytes=n * elem_bytes,
                    direction="d2h")
                # the link carried the PACKED carrier; decode is host-side
                acct["down"] += n * np.dtype(key_dtype).itemsize + \
                    sum(v.nbytes for v in leaves_np)
                chunk_down = acct["down"]
            except RetriesExhausted:
                # the device runs are gone, so every rung restarts the
                # attempt — kway first, then re-chunk
                _abort_attempt()
                if kway > 2:
                    kway = max(2, kway // 2)
                    faultlog.degradations += 1
                    continue
                if not _rechunk_smaller():
                    raise
                continue
        break

    h2d = chunk_up + spill_up + faultlog.retry_h2d_bytes
    d2h = chunk_down + spill_down + faultlog.retry_d2h_bytes
    stats = OocStats(
        len(lens), rounds, chunk_elems, h2d, d2h,
        device_high_water_bytes=ledger.high,
        chunk_link_bytes=chunk_up + chunk_down,
        spill_link_bytes=spill_up + spill_down,
        rounds_spilled=rounds if spill else 0,
        spill_slab_elems=slab,
        retries=faultlog.retries,
        faults_injected=faultlog.faults_injected,
        degradations=faultlog.degradations,
        checksum_failures=faultlog.checksum_failures,
        rounds_checkpointed=faultlog.rounds_checkpointed,
        retry_link_bytes=faultlog.retry_link_bytes,
        chunk_passes_executed=sum(int(p) for p in cpasses))
    return finish(keys_np, leaves_np, stats)


def _resume(resume_from: str, *, spill_budget_bytes, faults, retry,
            checkpoint_dir, checkpoint_every, values_like, return_stats,
            faultlog: FaultLedger, ledger: _DeviceLedger, link: _Link):
    """Replay an interrupted spill merge from its newest published round,
    adopting the manifest's plan (kway/tile/slab/key dtype).  Stats cover
    only this process's work."""
    meta, keys_h, vals_h = _load_round_checkpoint(resume_from)
    kway, tile, slab = meta["kway"], meta["tile"], meta["slab"]
    key_dtype = np.dtype(meta["key_dtype"])    # packed carrier if compressed
    comp = meta.get("compress")
    cplan = None
    out_dtype = key_dtype
    if comp is not None:
        cplan = bijection.CompressionPlan(mask=int(comp["mask"]),
                                          dead=int(comp["dead"]),
                                          source_bits=int(comp["source_bits"]))
        out_dtype = np.dtype(comp["orig_dtype"])
    elem_bytes = key_dtype.itemsize + \
        sum(np.dtype(d).itemsize for d in meta["value_dtypes"])
    if spill_budget_bytes is not None and _spill_peak_bytes(
            slab, tile, elem_bytes, kway) > spill_budget_bytes:
        raise ValueError(
            f"resume_from plan (slab={slab}, kway={kway}, tile={tile}) "
            f"models a peak above spill_budget_bytes={spill_budget_bytes}; "
            f"resume with the original budget or none")
    if faults is not None and meta.get("fault_state"):
        faults.load_state(meta["fault_state"])
    same_dir = checkpoint_dir is not None and \
        os.path.abspath(checkpoint_dir) == os.path.abspath(resume_from)
    try:
        keys_h0, vals_h0, rounds, up, down, kway, slab = _merge_spilled(
            keys_h, vals_h, round_idx=meta["round"], kway=kway, tile=tile,
            slab=slab, budget=spill_budget_bytes, elem_bytes=elem_bytes,
            ledger=ledger, faults=faults, retry=retry,
            faultlog=faultlog, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            meta_base={k: meta[k] for k in
                       ("key_dtype", "n", "num_leaves", "value_dtypes",
                        "num_chunks", "chunk_elems", "compress")
                       if k in meta},
            link=link, checksums=[tuple(cs) for cs in meta["checksums"]],
            save_incoming=not same_dir)
    except _RechunkEscalation as esc:
        raise esc.cause      # no host chunks to re-split in a resumed run

    if cplan is not None:
        keys_h0 = bijection.unpack_ordered_bits_np(keys_h0, cplan)
    keys_np = bijection.from_ordered_bits_np(keys_h0, out_dtype)
    leaves_np = tuple(vals_h0)
    nl = meta["num_leaves"]
    if nl == 0:
        out = (keys_np,)
    elif values_like is not None:
        like, td = _flatten(values_like)
        if len(like) != nl:
            raise ValueError(f"values_like has {len(like)} leaves; the "
                             f"checkpoint recorded {nl}")
        out = (keys_np, interop.tree_unflatten(td, list(leaves_np)))
    elif nl == 1:
        out = (keys_np, leaves_np[0])
    else:
        out = (keys_np, leaves_np)
    if return_stats:
        stats = OocStats(
            meta["num_chunks"], rounds, meta["chunk_elems"],
            up + faultlog.retry_h2d_bytes, down + faultlog.retry_d2h_bytes,
            device_high_water_bytes=ledger.high,
            chunk_link_bytes=0,
            spill_link_bytes=up + down,
            rounds_spilled=rounds,
            spill_slab_elems=slab,
            retries=faultlog.retries,
            faults_injected=faultlog.faults_injected,
            degradations=faultlog.degradations,
            checksum_failures=faultlog.checksum_failures,
            rounds_checkpointed=faultlog.rounds_checkpointed,
            retry_link_bytes=faultlog.retry_link_bytes)
        out = out + (stats,)
    return out[0] if len(out) == 1 else out


# --- contract declarations (verified by repro_torch.analysis; see
# analysis/contracts)
# §5 census + transfer tables: a chunk sort inherits the hybrid contract at
# chunk size; a device merge round and a spill slab sweep are each ONE
# kway_merge_round launch moving exactly one read + one write sweep of the
# (pad_length-sized) run/slab buffer.
ANALYSIS_CONTRACTS = {
    "ooc_chunk_sort": {
        "entry": "repro_torch.core.outofcore._sort_chunk",
        "census": {"launch_total": "2 + classes",
                   "while_body_launches": "[1]"},
        "sort_free": True,
        "donation": {"_fused_pass_kernel": "1 + vals"},
        "transfer": {
            "sweep_kernels": ["_hist_kernel", "_fused_pass_kernel"],
            "bytes": "(2 * passes + 1) * n_pad * kb"
                     " + 2 * passes * n_pad * vb",
        },
    },
    "ooc_merge_round": {
        "entry": "repro_torch.core.outofcore.merge_round",
        "census": {"launch_total": "1", "while_body_launches": "[]"},
        "sort_free": True,
        "donation": {"_kway_merge_kernel": "1 + vals"},
        "transfer": {
            "sweep_kernels": ["_kway_merge_kernel"],
            "bytes": "2 * n_pad * kb + 2 * n_pad * vb",
        },
    },
    "ooc_slab_sweep": {
        "entry": "repro_torch.kernels.merge.kway_merge_round",
        "census": {"launch_total": "1", "while_body_launches": "[]"},
        "sort_free": True,
        "donation": {"_kway_merge_kernel": "1 + vals"},
        "transfer": {
            "sweep_kernels": ["_kway_merge_kernel"],
            "bytes": "2 * n_pad * kb + 2 * n_pad * vb",
        },
    },
}
