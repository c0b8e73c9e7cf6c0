"""A later change adds a cell by adding files and entries only: a copy of
the benchmark gets a configuration of int32 bucket ids with a payload,
a mix of Zipf(1.2) ids over 384 buckets, an entry that keeps its inputs
in host memory (its ``prepare``) and a new cell in ``BENCHMARK.json``;
the cell runs whole and correct, and no file the benchmark had changes
but ``BENCHMARK.json``."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from ._tiny import ROOT

CONFIG = {"name": "ids384", "entry": "host_partition",
          "reference": "stable_sort", "records": 5000,
          "columns": {"keys": "int32", "values": "int64"},
          "guarantees": ["ids ascending, equal ids in input order"]}
MIX = {"inputs": 2, "columns": {"keys": {"dist": "zipf", "a": 1.2,
                                         "n": 384}}}
#: a stand-in for a partition entry over inputs in host memory: it moves
#: them to host memory outside the window and partitions them (a stable
#: sort by bucket id) on each call
ENTRY = '''
import torch


def prepare(inputs, config):
    out = []
    for inp in inputs:
        host = {k: v.to("cpu") for k, v in inp.items()}
        if torch.cuda.is_available():
            host = {k: v.pin_memory() for k, v in host.items()}
        host["keys"].placed_by = "host_partition.prepare"
        out.append(host)
    return out


def call(inp, config):
    assert inp["keys"].device.type == "cpu"
    order = torch.sort(inp["keys"], stable=True).indices
    return {k: v[order] for k, v in inp.items()}


def describe(inp, config):
    return {"placed_by": getattr(inp["keys"], "placed_by", None),
            "buckets": int(inp["keys"].max()) + 1}


def counters():
    return {"kernel_launches": 0, "host_reads": 0}


def kernel_names():
    return set()
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_bounded_id_cell_in_host_memory_is_added_as_files(tmp_path):
    bench_dir = tmp_path / "sortbench"
    shutil.copytree(ROOT / "sortbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ids384", "source": "https://x.org",
                             "file": "sortbench/configs/ids384.json",
                             "reduced": [], "why": "bucket ids"})
    bench["workloads"].append({"name": "ids384.zipf", "config": "ids384",
                               "traffic": "ids384_zipf", "chips": 1,
                               "why": "Zipf(1.2) ids over 384 buckets"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (bench_dir / "configs" / "ids384.json").write_text(json.dumps(CONFIG))
    (bench_dir / "traffic" / "ids384_zipf.json").write_text(json.dumps(MIX))
    (bench_dir / "entries" / "host_partition.py").write_text(ENTRY)

    code = ("import json, sys; sys.path[:0] = ['.', sys.argv[1]]\n"
            "from sortbench import harness\n"
            "spec = harness.load_spec('.', 'ids384.zipf')\n"
            "print(json.dumps(harness.run(spec, 2**33 + 5, 0.2, False, "
            "'cpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, str(ROOT / "src")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    cell = next(x for x in lines if "cell" in x)
    assert cell["placed_by"] == "host_partition.prepare"
    assert cell["buckets"] <= 384
    result = lines[-1]
    assert result["correct"] is True and result["outputs_checked"] >= 2
    assert result["checks"]["value_mismatch"] == {"value": 0, "limit": 0}
    added = {"configs/ids384.json", "traffic/ids384_zipf.json",
             "entries/host_partition.py"}
    after = {k: v for k, v in _digests(bench_dir).items() if k not in added}
    assert after == before
