"""Round checkpoints of the out-of-core sort: atomic, content-hashed, zlib.

Port of the part of ``repro.checkpoint.store`` that ``oocsort`` needs:
``save_checkpoint``, ``latest_steps``, ``latest_step`` and
``restore_blind``.  The layout is the reference's — one directory
``step_<10 digits>`` per step, one compressed chunk file per leaf, a
``manifest.json`` with each chunk's dtype, shape and the sha256 of its
compressed bytes, published by one atomic rename — with two differences:
the flatten-with-path key list is stored as ``paths.json`` (JSON, not
msgpack) and chunks are ``zlib`` streams (``chunk_<6 digits>.zlib``), so
nothing beyond the standard library and numpy is needed.  A checkpoint
written by this module is therefore not readable by the reference's store,
and the reverse; nothing in the port needs either.

The tree is a flat ``{name: numpy array}`` dict (what ``oocsort`` writes);
keys are stored as the reference's key strings (``"['name']"``), so the
out-of-core sort strips them the same way.  ``restore_checkpoint(like)`` and
``AsyncCheckpointer`` belong to the trainer and are not ported yet.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import Dict, Optional

import numpy as np


def save_checkpoint(directory: str, step: int, tree: Dict[str, np.ndarray],
                    keep: int = 3) -> str:
    """Write ``tree`` as checkpoint ``step``; prune to the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    names = sorted(tree)
    arrs = [np.ascontiguousarray(tree[k]) for k in names]
    meta = [{"dtype": a.dtype.str, "shape": list(a.shape)} for a in arrs]
    hashes = []
    for i, a in enumerate(arrs):
        comp = zlib.compress(a.tobytes(), 3)
        hashes.append(hashlib.sha256(comp).hexdigest())
        with open(os.path.join(tmp, f"chunk_{i:06d}.zlib"), "wb") as f:
            f.write(comp)
    manifest = {"step": step, "num_chunks": len(arrs), "meta": meta,
                "hashes": hashes, "process": 0}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "paths.json"), "w") as f:
        json.dump([f"['{k}']" for k in names], f)
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


def restore_blind(directory: str, step: int) -> Dict[str, np.ndarray]:
    """Restore checkpoint ``step`` without a ``like`` tree.

    Every chunk is hash-checked, decompressed and rebuilt from the
    manifest's dtype and shape; returns ``{keystr: array}`` keyed by the
    recorded key strings.  A chunk whose bytes no longer match their sha256
    raises ``IOError``.
    """
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "paths.json")) as f:
        paths = json.load(f)
    if len(paths) != manifest["num_chunks"]:
        raise IOError("checkpoint paths and manifest disagree")
    out = {}
    for i, (keystr, meta) in enumerate(zip(paths, manifest["meta"])):
        with open(os.path.join(path, f"chunk_{i:06d}.zlib"), "rb") as f:
            comp = f.read()
        if hashlib.sha256(comp).hexdigest() != manifest["hashes"][i]:
            raise IOError(f"checkpoint chunk {i} corrupt")
        out[keystr] = np.frombuffer(
            zlib.decompress(comp),
            dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
    return out
