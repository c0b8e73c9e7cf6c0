"""The port's user-facing entries against the reference's, on the CPU.

* ``scripts/torch_smoke_sort.py`` and ``examples/torch_quickstart.py``
  print the reference scripts' lines (run in subprocesses, started at
  once by a module fixture): the same text, except that a ``stats=``
  line's ``SortStats`` compares its five fields as integers (the
  reference's repr holds jax arrays).
* ``examples/torch_distributed_sort.py`` at the reference's draws cut to
  2^14 keys on ``LocalMesh(8, "cpu")``: the padded keys and ids byte for
  byte and ``exchange_attempts``, ``overflow`` and ``valid`` equal to the
  reference's ``make_distributed_sort`` on 8 fake host devices.
* ``examples/torch_serve_decode.py`` with the reference's parameters
  carried across: the same batches, lengths and tokens.
* ``examples/torch_train_moe.py``: both configs and their parameter
  counts equal the reference's; a 50-step run resumed to 52 gives the
  losses of an uninterrupted 52-step run, bit for bit.
* ``scripts/torch_probe_multipod.py``: each of the five collective kinds
  counted, at the reference's wire factors.
* ``scripts/torch_make_experiments_tables.py`` on artifacts written from
  ``utils.roofline.Roofline.row()``: every ``ok`` cell once per table.
* Each of the seven entries, without ``--device cpu`` and without a card,
  exits non-zero with the "no CUDA device" error and prints nothing.
"""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from _multidev import PREAMBLE  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params, params_from_reference  # noqa: E402
from repro_torch.utils.roofline import Roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENTRIES = ("examples/torch_quickstart.py",
           "examples/torch_distributed_sort.py",
           "examples/torch_serve_decode.py", "examples/torch_train_moe.py",
           "scripts/torch_smoke_sort.py", "scripts/torch_probe_multipod.py",
           "scripts/torch_make_experiments_tables.py")
DIST_N = 1 << 14

#: the reference's distributed example at DIST_N keys on 8 fake devices
#: (its draws made the same way), the outputs saved for the port's run
_DIST_BODY = """
import sys
n, path = {n}, {path!r}
rng = np.random.default_rng(0)
out = {{}}
for i, (name, ands, chunks) in enumerate((("uniform s=1", 0, 1),
        ("skewed s=1", 3, 1), ("uniform s=4 (pipelined)", 0, 4))):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    for _ in range(ands):
        x &= rng.integers(0, 2**32, n, dtype=np.uint32)
    fn = jax.jit(make_distributed_sort(mesh, "data", num_chunks=chunks,
                                       engine="argsort"))
    k, st = fn(jnp.asarray(x))
    out.update({{f"k{{i}}": np.asarray(k), f"a{{i}}": np.asarray(
        st.exchange_attempts), f"o{{i}}": np.asarray(st.overflow),
        f"v{{i}}": np.asarray(st.valid)}})
x = rng.integers(0, 2**32, n, dtype=np.uint32)
ids = np.arange(n, dtype=np.int32)
fn = jax.jit(make_distributed_sort(mesh, "data", engine="argsort"))
k, i, st = fn(jnp.asarray(x), jnp.asarray(ids))
out.update(k3=np.asarray(k), i3=np.asarray(i), a3=np.asarray(
    st.exchange_attempts), o3=np.asarray(st.overflow), v3=np.asarray(st.valid))
np.savez(path, **out)
"""


def _load(rel, name):
    """An entry script as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _popen(args, env_extra=None, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's smoke_sort and quickstart output and its
    distributed example at ``DIST_N`` keys, their processes started at
    once; ``{name: (rc, stdout, stderr)}`` and the outputs' ``.npz``."""
    path = str(tmp_path_factory.mktemp("ref") / "dist.npz")
    body = textwrap.dedent(_DIST_BODY.format(n=DIST_N, path=path))
    procs = {
        "smoke_sort": _popen(["scripts/smoke_sort.py"]),
        "quickstart": _popen(["examples/quickstart.py"]),
        "dist": _popen(["-c", PREAMBLE + body], {
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        out[name] = (proc.returncode, stdout, stderr[-3000:])
    out["dist_npz"] = path
    return out


@pytest.fixture(scope="module")
def without_card():
    """Each entry run as a user runs it, with no card and no ``--device``:
    ``{entry: (rc, stdout, stderr)}``, the processes started at once."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entries would run for real")
    procs = {rel: _popen([rel], {"CUDA_VISIBLE_DEVICES": ""})
             for rel in ENTRIES}
    return {rel: (p.returncode, *p.communicate(timeout=300))
            for rel, p in procs.items()}


_FIELD = re.compile(r"(\w+)=(?:Array\()?(True|False|-?\d+)")


def _stats_fields(line):
    """The five ``SortStats`` fields of a ``stats=`` line as ints."""
    head, stats = line.split("stats=", 1)
    if stats == "None":
        return head, None
    return head, {k: int(v == "True") if v in ("True", "False") else int(v)
                  for k, v in _FIELD.findall(stats)}


def _same_lines(got, want):
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if "stats=" in w:
            gh, gs = _stats_fields(g)
            wh, ws = _stats_fields(w)
            assert gh == wh and gs == ws, (g, w)
            assert ws is None or len(ws) == 5, w
        else:
            assert g == w


@pytest.mark.parametrize("name,rel", [
    ("smoke_sort", "scripts/torch_smoke_sort.py"),
    ("quickstart", "examples/torch_quickstart.py")])
def test_prints_the_reference_lines(reference, capsys, name, rel):
    rc, want, err = reference[name]
    assert rc == 0, err
    capsys.readouterr()
    _load(rel, f"port_{name}").run(device="cpu")
    _same_lines(capsys.readouterr().out, want)


def test_smoke_sort_returns_the_printed_stats(capsys):
    stats = _load("scripts/torch_smoke_sort.py", "port_smoke").run(
        device="cpu", sizes=(0, 100), n=300)
    assert stats["n=0"] is None
    assert stats["n=100"].counting_passes == 1
    assert set(stats) == {"n=0", "n=100", "uniform_u32", "skew_and3",
                          "const", "int32", "f32"}
    assert "SMOKE OK" in capsys.readouterr().out


def test_distributed_sort_matches_reference(reference):
    rc, _, err = reference["dist"]
    assert rc == 0, err
    want = np.load(reference["dist_npz"])
    mod = _load("examples/torch_distributed_sort.py", "port_dist")
    got = mod.run(device="cpu", n=DIST_N)
    for i, name in enumerate([c[0] for c in mod.CASES] + ["kv pairs"]):
        keys, ids, st = got[name]
        assert keys.numpy().tobytes() == want[f"k{i}"].tobytes(), name
        if ids is not None:
            assert ids.numpy().tobytes() == want[f"i{i}"].tobytes(), name
        assert np.array_equal(st.exchange_attempts.numpy(), want[f"a{i}"])
        assert np.array_equal(st.overflow.numpy(), want[f"o{i}"])
        assert np.array_equal(st.valid.numpy(), want[f"v{i}"])


def test_serve_decode_matches_reference_with_its_params(capsys):
    """The reference example's engine and queue in this process; the
    port's run with those parameters carried across."""
    arch = "internlm2_1_8b"
    cfg = jcfg.get_smoke_config(arch)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    engine = jeng.ServeEngine(cfg, params, batch_size=4, max_len=128)
    rng = np.random.default_rng(0)
    queue = [jeng.Request(rid=i,
                          prompt=rng.integers(0, cfg.vocab,
                                              int(rng.integers(4, 16))),
                          max_new_tokens=int(rng.integers(8, 32)))
             for i in range(10)]
    want = [engine.generate(b) for b in engine.schedule(queue)]
    tp = params_from_reference(get_smoke_config(arch),
                               jax.tree.map(np.asarray, params), device="cpu")
    got = _load("examples/torch_serve_decode.py", "port_serve").run(
        device="cpu", params=tp)
    assert [[r.rid for r in b] for b in got] == \
        [[r.rid for r in b] for b in want]
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert len(g.generated) == len(w.generated) == w.max_new_tokens
            assert g.generated.dtype == np.int32
            assert np.array_equal(g.generated, w.generated), w.rid
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"10 requests -> {len(want)} batches (sorted by "
                      f"remaining-length class to cut straggler idle)")
    assert len(out) == 11


def test_serve_decode_seeded_params_run(capsys):
    """Without ``params``: a generator seeded 0 on the device."""
    served = _load("examples/torch_serve_decode.py", "port_serve2").run(
        device="cpu", requests=3)
    assert sum(len(b) for b in served) == 3
    cfg = get_smoke_config("internlm2_1_8b")
    assert all(0 <= r.generated.min() and r.generated.max() < cfg.vocab
               for b in served for r in b)
    assert "3 requests -> " in capsys.readouterr().out


@pytest.fixture(scope="module")
def train_moe():
    return (_load("examples/train_moe.py", "ref_train_moe"),
            _load("examples/torch_train_moe.py", "port_train_moe"))


@pytest.mark.parametrize("small", [True, False])
def test_train_moe_config_and_params_equal_reference(train_moe, small):
    ref, port = train_moe
    got, want = port.make_cfg(small), ref.make_cfg(small)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the parameter count: the small model drawn on the CPU, the 100M
    # model's shapes only (meta tensors; the reference's eval_shape)
    device = "cpu" if small else "meta"
    tree = jax.eval_shape(lambda: jm.init_params(want, jax.random.PRNGKey(0)))
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert port.param_count(init_params(got, device=device)) == n_ref


def test_train_moe_resumes_bit_equal(train_moe, tmp_path, capsys):
    """50 steps, then the same command to 52 resumes from the step-50
    checkpoint; its steps 51-52 equal an uninterrupted 52-step run's."""
    _, port = train_moe
    kw = dict(small=True, device="cpu")
    first = port.run(steps=50, ckpt=str(tmp_path / "a"), **kw)
    assert first["start"] == 0 and sorted(first["losses"]) == list(
        range(1, 51))
    out = capsys.readouterr().out
    assert "[trainer] resumed" not in out
    assert out.splitlines()[0] == ("[example] qwen3-moe-micro: 1.9M params, "
                                   "8 experts top-2, sort-based dispatch")
    assert "[trainer] step 50 loss=" in out
    resumed = port.run(steps=52, ckpt=str(tmp_path / "a"), **kw)
    assert "[trainer] resumed from step 50" in capsys.readouterr().out
    assert resumed["start"] == 50 and sorted(resumed["losses"]) == [51, 52]
    whole = port.run(steps=52, ckpt=str(tmp_path / "b"), **kw)
    assert [whole["losses"][s] for s in (51, 52)] == \
        [resumed["losses"][s] for s in (51, 52)]
    assert whole["losses"][50] == first["losses"][50]
    assert np.isfinite(list(whole["losses"].values())).all()


def test_probe_counts_each_collective_at_the_wire_factors():
    proc = _popen(["scripts/torch_probe_multipod.py", "--device", "cpu"])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = out.splitlines()
    assert lines[-1] == "PROBE OK"
    assert "devices: 512" in lines
    assert "mesh ok: {'pod': 2, 'data': 16, 'model': 16}" in lines
    got = {}
    for line in lines:
        m = re.fullmatch(r"([a-z-]+) (\d+) wire_bytes=(\d+)", line)
        if m:
            got[m.group(1)] = (int(m.group(2)), int(m.group(3)))
    # this rank's (16, 64) float32 block of the (512, 1024) array: 4096 B;
    # the reference's factors over P = 16 (data, model) and one pod hop
    block, frac = 16 * 64 * 4, 15 / 16
    assert got == {"all-reduce": (1, 2 * block * frac),
                   "all-gather": (1, 16 * block * frac),
                   "reduce-scatter": (1, 16 * block * frac),
                   "all-to-all": (1, block * frac),
                   "collective-permute": (1, block)}
    mem = re.search(r"mem: \{'argument_bytes': (\d+)", out)
    # x's (8, 1024) and w's (1024, 256) bf16 shards
    assert int(mem.group(1)) == (8 * 1024 + 1024 * 256) * 2
    assert "step mesh: {'data': 32, 'model': 16}" in out


def _artifacts(tmp_path, name, cells, skipped=()):
    """Dry-run artifacts as ``launch/dryrun.py`` writes them: a row of
    ``Roofline.row()`` and the port's extra keys per cell, and
    ``summary.json`` with the skipped cells."""
    out = tmp_path / name
    out.mkdir()
    arts = []
    for i, (mesh, arch, shape, mem) in enumerate(cells):
        row = Roofline(arch=arch, shape=shape, step="train", mesh=mesh,
                       chips=256 if mesh == "pod" else 512,
                       flops_per_chip=1e12 * (i + 1),
                       hbm_bytes_per_chip=1e10, coll_bytes_per_chip=1e9,
                       model_flops_global=1e14, mem_per_chip=mem).row()
        art = dict(row, build_s=1.5, run_s=2.5 + i, layer_fit={},
                   collective_bytes={"total": 1e9},
                   collective_counts={"all-reduce": 3, "all-to-all": 2},
                   memory={"argument_bytes": 2**31,
                           "peak_step_bytes": 2**30}, local_ops=10, ok=True)
        arts.append(art)
        (out / f"{mesh}_{arch}_{shape}.json").write_text(json.dumps(art))
    summary = arts + [{"arch": a, "shape": s, "mesh": m, "ok": False,
                       "skipped": "full-attention arch: 524k dense KV"}
                      for m, a, s in skipped]
    (out / "summary.json").write_text(json.dumps(summary))
    return out


_CELLS = [(m, "qwen3_moe_30b_a3b", s, mem) for m in ("pod", "multipod")
          for s, mem in (("train_4k", 9e10), ("decode_32k", 2e10))]


def _sections(text):
    out, title = {}, None
    for line in text.splitlines():
        if line.startswith("### "):
            title = line[4:]
            out[title] = []
        elif line.startswith("| ") and title:
            out[title].append(line)
    return out


@pytest.mark.parametrize("optimized", [False, True])
def test_tables_from_port_artifacts(tmp_path, optimized):
    # The reference's make_experiments_tables.py stops on these artifacts
    # with KeyError: 'fits_16gib' (and would read compile_s and
    # memory_analysis): why the port keeps its own copy of the script.
    skip = [("pod", "qwen3_moe_30b_a3b", "long_500k")]
    base = _artifacts(tmp_path, "base", _CELLS, skip)
    opt = (_artifacts(tmp_path, "opt", _CELLS, skip) if optimized
           else tmp_path / "missing")
    mod = _load("scripts/torch_make_experiments_tables.py", "port_tables")
    out = tmp_path / "artifacts" / "tables_torch.md"
    text = mod.run(str(base), str(opt), out_path=str(out), device="cpu")
    assert out.read_text() == text
    assert "16gib" not in text.lower() and "chips" not in text
    sec = _sections(text)
    want = ["Dry-run — pod mesh (16x16 = 256 GPUs)",
            "Dry-run — multipod mesh (2x16x16 = 512 GPUs)"]
    assert list(sec)[:2] == want
    assert len(sec) == (6 if optimized else 3)
    for title, rows in sec.items():
        of = "multipod" if "multipod" in title or "multi-pod" in title \
            else "pod"
        cells = [r.split(" | ") for r in rows
                 if not r.startswith("| arch |") and "| SKIP |" not in r]
        # each ok cell of the table's mesh once, no other
        assert sorted((c[0][2:], c[1]) for c in cells) == sorted(
            (arch, shape) for mesh, arch, shape, _ in _CELLS if mesh == of)
        for c in cells:
            mem = next(m for mesh, a, s, m in _CELLS if mesh == of and
                       (a, s) == (c[0][2:], c[1]))
            if title.startswith("Roofline"):
                assert c[-1] == ("Y |" if mem <= 80e9 else "n |")
                assert c[-2] == f"{mem / 2**30:.1f}"
            if title.startswith("Dry-run"):
                assert c[3:] == ["1.5", c[4], "2.00", "1.00", "3/0/0/2/0 |"]
    skip_rows = [r for r in sec[want[0]] if "| SKIP |" in r]
    assert len(skip_rows) == 1 and "long_500k" in skip_rows[0]
    assert not [r for r in sec[want[1]] if "| SKIP |" in r]


@pytest.mark.parametrize("rel", ENTRIES)
def test_entry_without_a_card_stops(without_card, rel):
    rc, out, err = without_card[rel]
    assert rc != 0
    assert out == ""
    assert "no CUDA device" in err
