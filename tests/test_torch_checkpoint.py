"""The port's checkpoint store: nested trees, bfloat16, integrity, pruning
and the asynchronous writer.

The port's file format is its own (zlib chunks, ``paths.json``), so the
reference cannot read its files; what is held to the reference is the
flatten order and the key strings (``jax.tree_util.keystr`` of the same
structure), and the behaviour of ``tests/test_substrate.py``'s checkpoint
tests.  A flat ``{name: array}`` dict, which the out-of-core sort writes,
keeps the files it always had.
"""
import json
import os
import threading
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,  # noqa: E402
                                    restore_blind, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import store  # noqa: E402


class State(NamedTuple):
    params: dict
    opt_state: dict
    step: object


def _nested(rng):
    bf = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)) \
        .to(torch.bfloat16)
    bits = bf.view(torch.int16)
    bits[0, :3] = torch.tensor([0x7FC1, -0x7F, 0x0001], dtype=torch.int16)
    params = {"embed": bf, "final_norm": torch.ones(7),
              "layers": [{"attn": {"wq": torch.from_numpy(
                  rng.standard_normal((7, 4)).astype(np.float32))},
                  "b_attn": torch.tensor(0.5)},
                  {"attn": {"wq": bf[:, :4].clone()},
                   "b_attn": torch.tensor(-0.25)}]}
    opt = {"m": {"mask": torch.tensor([True, False, True]),
                 "pair": (np.arange(6, dtype=np.uint32).reshape(2, 3),
                          np.float64(2.5))},
           "count": torch.tensor(3, dtype=torch.int32)}
    return State(params, opt, torch.tensor(11, dtype=torch.int64))


def _leaves(tree):
    return [v for _, v in store._flatten(tree)]


def _same_bits(a, b):
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.cpu(), b.cpu())


def _zeros_like(tree):
    return store._map(lambda v: torch.zeros_like(v) if isinstance(
        v, torch.Tensor) else np.zeros_like(v), tree)


def test_nested_tree_round_trips_bit_for_bit(tmp_path, rng):
    """A TrainState-like tree of dicts, a list, a tuple, a NamedTuple, with
    bfloat16 (NaN, subnormal and negative patterns), float32, bool, int
    tensors and numpy leaves: restored into zeros of the same structure,
    every leaf has its bits, dtype and type back."""
    tree = _nested(rng)
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    back = restore_checkpoint(str(tmp_path), 5, _zeros_like(tree))
    assert isinstance(back, State) and isinstance(back.params["layers"], list)
    assert isinstance(back.opt_state["m"]["pair"], tuple)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert type(a) is type(b) or isinstance(b, np.ndarray)
        assert _same_bits(a, b)


def test_key_strings_are_the_references(tmp_path, rng):
    """``paths.json`` lists the leaves in ``jax.tree``'s flatten order under
    ``jax.tree_util.keystr``'s names (NamedTuple fields as ``.name``)."""
    tree = _nested(rng)
    save_checkpoint(str(tmp_path), 1, tree)
    with open(tmp_path / "step_0000000001" / "paths.json") as f:
        paths = json.load(f)
    jtree = store._map(lambda v: jnp.zeros(np.shape(v)), tree)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert paths == want
    assert ".params['layers'][0]['attn']['wq']" in paths
    with open(tmp_path / "step_0000000001" / "manifest.json") as f:
        meta = json.load(f)["meta"]
    assert meta[paths.index(".params['embed']")] == {
        "dtype": "bfloat16", "shape": [5, 7]}


def test_flat_dict_files_unchanged(tmp_path, rng):
    """What ``oocsort`` writes: ``['name']`` keys in sorted order, numpy
    dtype strings, and ``restore_blind`` gives the arrays back."""
    tree = {"k0001": rng.integers(0, 2**32, 9, dtype=np.uint32),
            "meta": np.frombuffer(b'{"a": 1}', np.uint8),
            "k0000": rng.standard_normal(4)}
    path = save_checkpoint(str(tmp_path), 2, tree)
    with open(os.path.join(path, "paths.json")) as f:
        assert json.load(f) == ["['k0000']", "['k0001']", "['meta']"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert [m["dtype"] for m in json.load(f)["meta"]] == \
            ["<f8", "<u4", "|u1"]
    back = restore_blind(str(tmp_path), 2)
    for k, v in tree.items():
        assert back[f"['{k}']"].tobytes() == v.tobytes()


def test_restore_follows_like_device_and_dtype(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32),
            "b": np.arange(3, dtype=np.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"a": torch.zeros(6, dtype=torch.float64),
            "b": np.zeros(3, np.int64)}
    back = restore_checkpoint(str(tmp_path), 1, like)
    assert back["a"].dtype == torch.float64 and back["b"].dtype == np.int64
    assert back["a"].tolist() == list(range(6))
    assert back["b"].tolist() == [0, 1, 2]


def test_restore_refuses_another_tree(tmp_path):
    tree = {"a": torch.zeros(4), "b": {"c": torch.ones(2, 3)}}
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1,
                           {"a": torch.zeros(5), "b": {"c": torch.ones(2, 3)}})
    with pytest.raises(ValueError, match="is \\['a'\\]"):
        restore_checkpoint(str(tmp_path), 1,
                           {"x": torch.zeros(4), "b": {"c": torch.ones(2, 3)}})


# ---- counterparts of the reference's checkpoint tests ----------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    back = restore_checkpoint(str(tmp_path), 5, _zeros_like(tree))
    for x, y in zip(_leaves(tree), _leaves(back)):
        assert _same_bits(x, y)


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    with open(os.path.join(path, "chunk_000000.zlib"), "r+b") as f:
        f.seek(4)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(IOError):
        restore_blind(str(tmp_path), 1)


def test_checkpoint_prunes_old(tmp_path):
    tree = {"a": torch.zeros(4)}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004",
                                            "step_0000000005"]


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, {"a": torch.arange(16.0)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 3


def test_async_checkpointer_snapshots_before_in_place_update(tmp_path,
                                                             monkeypatch):
    """The writer is held until the tree has been updated in place (as the
    optimizer does): the file still holds the values at ``save``."""
    gate = threading.Event()
    write = store.save_checkpoint

    def held(*a, **kw):
        assert gate.wait(timeout=60)
        return write(*a, **kw)

    monkeypatch.setattr(store, "save_checkpoint", held)
    tree = State({"w": torch.arange(8.0).to(torch.bfloat16)},
                 {"m": torch.zeros(8)}, torch.tensor(4))
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(4, tree)
    tree.params["w"].add_(100)
    tree.opt_state["m"].fill_(7)
    gate.set()
    ck.wait()
    back = restore_checkpoint(str(tmp_path), 4, _zeros_like(tree))
    assert back.params["w"].float().tolist() == list(map(float, range(8)))
    assert back.opt_state["m"].tolist() == [0.0] * 8


def test_async_checkpointer_wait_reraises(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_checkpoint", broken)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                                   # the error is raised once
