"""Rules every slice of the port is held to.

* No module under ``src/repro_torch/``, not ``chip_smoke.py``, no
  ``scripts/torch_*.py`` script and no ``examples/torch_*.py`` example
  imports ``jax`` or the reference package ``repro`` (checked on the source's AST
  and on ``sys.modules`` after importing the port in a fresh interpreter).
* No quiet move to the CPU: a numpy input with no ``device=`` goes to the
  GPU, and without one it raises; a kernel wrapper given a tensor that is
  neither on the CPU nor on CUDA raises instead of running anything.
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU, and
  when it stands alone without the repository.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = {"jax", "jaxlib", "repro"}


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] +
            sorted((ROOT / "scripts").glob("torch_*.py")) +
            sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_reference():
    sources = _port_sources()
    assert len(sources) > 10
    for path in sources:
        bad = BANNED & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.hybrid, "
            "repro_torch.kernels.fused, repro_torch.kernels.bitonic, "
            "repro_torch.kernels.multisplit, repro_torch.kernels.assigned, "
            "repro_torch.kernels.ops, repro_torch.core.interop, "
            "repro_torch.data, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.serve, repro_torch.optim, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.checkpoint, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.dryrun, repro_torch.utils, "
            "repro_torch.utils.roofline, repro_torch.utils.collectives, "
            "repro_torch.optim.compression, repro_torch.analysis, "
            "repro_torch.analysis.__main__, repro_torch.utils.census\n"
            "import repro_torch.configs as c\n"
            "[c.get_config(a) for a in c.ARCHS]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED)!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_numpy_input_goes_to_the_gpu_or_raises():
    from repro_torch import hybrid_sort
    x = np.arange(100, dtype=np.uint32)[::-1].copy()
    if torch.cuda.is_available():
        out = hybrid_sort(x)
        assert out.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hybrid_sort(x)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hybrid_sort(x, device="cuda")
    out = hybrid_sort(x, device="cpu")
    assert out.device.type == "cpu"
    assert np.array_equal(out.numpy(), np.sort(x))


def test_distributed_and_bucketing_go_to_the_gpu_or_raise():
    """``LocalMesh`` built with no device is the GPU (it raises without
    one), and ``length_bucketed_batches`` sends numpy lengths to the GPU
    unless the caller asks for the CPU."""
    from repro_torch.core import LocalMesh, make_distributed_sort
    from repro_torch.data import length_bucketed_batches
    x = np.arange(256, dtype=np.uint32)[::-1].copy()
    if torch.cuda.is_available():
        out, stats = make_distributed_sort(LocalMesh(2))(x)
        assert out.device.type == "cuda" and stats.valid.device.type == "cuda"
        order, _ = length_bucketed_batches(x, 1024)
        assert np.array_equal(order, np.arange(256)[::-1])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalMesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            length_bucketed_batches(x, 1024)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            length_bucketed_batches(x, 1024, ooc_chunk_elems=64)
    out, _ = make_distributed_sort(LocalMesh(2, "cpu"))(x)
    assert out.device.type == "cpu"
    with pytest.raises(ValueError, match="mesh runs on"):
        make_distributed_sort(LocalMesh(2, "cpu"))(torch.from_numpy(x).to(
            "meta"))
    order, bounds = length_bucketed_batches(x, 1024, device="cpu")
    assert np.array_equal(order, np.arange(256)[::-1]) and bounds[-1] == 256


def test_trainer_and_token_stream_go_to_the_gpu_or_raise(tmp_path):
    """``Trainer`` and ``SyntheticLMData`` with no ``device=`` are the GPU:
    without one they raise instead of running on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launch
    from repro_torch.train import Trainer
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=8, global_batch=2)
    tr = Trainer(cfg, data, str(tmp_path))
    if torch.cuda.is_available():
        assert data.batch(0)["tokens"].device.type == "cuda"
        state = tr.init_or_resume(0)
        assert state.params["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data.batch(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.init_or_resume(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main(["--arch", "qwen3_moe_30b_a3b", "--smoke",
                         "--steps", "1", "--ckpt-dir", str(tmp_path)])
    cpu = SyntheticLMData(vocab=cfg.vocab, seq_len=8, global_batch=2,
                          device="cpu")
    assert cpu.batch(0)["tokens"].device.type == "cpu"


def test_work_follows_the_tensor_device():
    from repro_torch import hybrid_sort
    x = torch.tensor([3, 1, 2], dtype=torch.int32)
    vals = np.array([30, 10, 20], np.int64)
    k, v = hybrid_sort(x, vals, engine="kernel")
    assert k.device.type == v.device.type == "cpu"
    assert k.tolist() == [1, 2, 3] and v.tolist() == [10, 20, 30]


def test_wrappers_reject_other_devices():
    from repro_torch.kernels import (assigned, bitonic, fused, histogram,
                                     multisplit)
    meta = torch.empty((2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        histogram.radix_histogram(meta, 0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.bitonic_sort_rows_stable(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.bitonic_sort_rows_kv(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        multisplit.tile_multisplit(meta, 0, 8, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        assigned.assigned_histogram(meta, meta[0], meta[0], 0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.initial_histogram(meta.reshape(-1), 100, 0, 8, 256, 1, 64)


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_without_gpu_or_repo_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert out.stdout == ""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = _run_smoke(tmp_path, lone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
