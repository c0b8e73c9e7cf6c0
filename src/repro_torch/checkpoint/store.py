"""Checkpoints: atomic, content-hashed, zlib, async-capable, resumable (port
of ``repro.checkpoint.store``).

The layout is the reference's — one directory ``step_<10 digits>`` per
step, one compressed chunk file per leaf, a ``manifest.json`` with each
chunk's dtype, shape and the sha256 of its compressed bytes, published by
one atomic rename — with two differences: the flatten-with-path key list
is stored as ``paths.json`` (JSON, not msgpack) and chunks are ``zlib``
streams (``chunk_<6 digits>.zlib``), so nothing beyond the standard
library and numpy is needed.  A checkpoint written by this module is
therefore not readable by the reference's store, and the reverse.

A tree is nested dicts (walked in sorted key order), ``NamedTuple``s (such
as ``TrainState``), lists and tuples, with torch tensors or numpy arrays
as leaves.  Each leaf's key string is the reference's
(``jax.tree_util.keystr``): ``.params['layers'][0]['attn']['wq']``; a flat
``{name: array}`` dict, which ``oocsort`` writes, gives ``['name']``.
bfloat16 (which numpy lacks) is stored as its 16-bit pattern with the
dtype tag ``"bfloat16"`` and restored bit for bit.

``restore_checkpoint(like)`` checks the leaf count, the key strings, the
sha256 of every chunk and every shape, raising on a mismatch, and puts
each leaf on the device and dtype of the matching leaf of ``like``.
``AsyncCheckpointer.save`` copies every leaf to the host before it
returns (the trainer updates its tensors in place), then compresses and
writes on a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = ""):
    """(key string, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _map(fn, tree):
    """``fn`` over the leaves in :func:`_flatten`'s order, keeping the
    structure (dict keys in their own order)."""
    if isinstance(tree, dict):
        done = {k: _map(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    return _map(lambda _: next(leaves), like)


def _encode(leaf):
    """(contiguous host array, dtype tag) of a leaf; bfloat16 as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        a = a if a.flags.c_contiguous else a.copy()   # keeps 0-d leaves 0-d
        if a.dtype.name == _BF16:                      # ml_dtypes' bfloat16
            return a.view(np.int16), _BF16
    return a, a.dtype.str


def _decode(raw: bytes, meta):
    """The leaf of one chunk: a numpy array, or a CPU bfloat16 tensor."""
    if meta["dtype"] == _BF16:
        bits = np.frombuffer(raw, np.int16).reshape(meta["shape"])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"])


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Write ``tree`` as checkpoint ``step``; prune to the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    pairs = list(_flatten(tree))
    meta, hashes = [], []
    for i, (_, leaf) in enumerate(pairs):
        a, dtype = _encode(leaf)
        meta.append({"dtype": dtype, "shape": list(a.shape)})
        comp = zlib.compress(a.tobytes(), 3)
        hashes.append(hashlib.sha256(comp).hexdigest())
        with open(os.path.join(tmp, f"chunk_{i:06d}.zlib"), "wb") as f:
            f.write(comp)
    manifest = {"step": step, "num_chunks": len(pairs), "meta": meta,
                "hashes": hashes, "process": 0}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "paths.json"), "w") as f:
        json.dump([k for k, _ in pairs], f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish

    steps = latest_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def latest_steps(directory: str):
    """Published steps in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def _open(directory: str, step: int):
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "paths.json")) as f:
        paths = json.load(f)
    if len(paths) != manifest["num_chunks"]:
        raise IOError("checkpoint paths and manifest disagree")
    return path, manifest, paths


def _chunk(path: str, manifest, i: int):
    """Chunk ``i``'s leaf, its sha256 checked (``IOError`` if corrupt)."""
    with open(os.path.join(path, f"chunk_{i:06d}.zlib"), "rb") as f:
        comp = f.read()
    if hashlib.sha256(comp).hexdigest() != manifest["hashes"][i]:
        raise IOError(f"checkpoint chunk {i} corrupt")
    return _decode(zlib.decompress(comp), manifest["meta"][i])


def restore_blind(directory: str, step: int) -> Dict[str, Any]:
    """Restore checkpoint ``step`` without a ``like`` tree.

    Every chunk is hash-checked, decompressed and rebuilt from the
    manifest's dtype and shape; returns ``{keystr: array}`` keyed by the
    recorded key strings (numpy arrays; a bfloat16 leaf as a CPU tensor).
    A chunk whose bytes no longer match their sha256 raises ``IOError``.
    """
    path, manifest, paths = _open(directory, step)
    return {k: _chunk(path, manifest, i) for i, k in enumerate(paths)}


def _like(leaf, ref):
    """``leaf`` on the device and in the dtype of ``ref``."""
    if isinstance(ref, torch.Tensor):
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.array(leaf))
        return t.to(device=ref.device, dtype=ref.dtype)
    want = np.asarray(ref).dtype
    if isinstance(leaf, torch.Tensor):     # bfloat16 bits into ml_dtypes'
        return leaf.view(torch.int16).numpy().view(want)
    return np.array(leaf, dtype=want)


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore checkpoint ``step`` into the structure of ``like``.

    Raises ``ValueError`` if the leaf count, a key string or a shape
    differs from ``like``'s, and ``IOError`` if a chunk is corrupt; each
    leaf goes to the device and dtype of its leaf in ``like``."""
    path, manifest, paths = _open(directory, step)
    want = list(_flatten(like))
    if len(want) != manifest["num_chunks"]:
        raise ValueError(f"checkpoint {step} has {manifest['num_chunks']} "
                         f"leaves, the tree {len(want)}")
    out = []
    for i, ((key, ref), saved) in enumerate(zip(want, paths)):
        if key != saved:
            raise ValueError(f"checkpoint leaf {i} is {saved}, the tree's "
                             f"{key}")
        leaf = _chunk(path, manifest, i)
        if tuple(leaf.shape) != tuple(np.shape(ref)):
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(leaf.shape)} != {tuple(np.shape(ref))}")
        out.append(_like(leaf, ref))
    return _rebuild(like, iter(out))


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        """Copy every leaf of ``tree`` to the host, then return; the write
        runs on a thread (its error surfaces at the next ``wait``)."""
        self.wait()
        if torch.cuda.is_available() and any(
                isinstance(v, torch.Tensor) and v.is_cuda
                for _, v in _flatten(tree)):
            torch.cuda.synchronize()
        host_tree = _map(_host_copy, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, self.keep)
            except BaseException as e:   # noqa: BLE001 — re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
