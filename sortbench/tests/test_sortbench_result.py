"""A whole run on the CPU at a tiny size: the result line's keys, the
metrics each mode reports, and the refusals of ``run.py``."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from sortbench import harness

from ._tiny import ROOT, tiny_run

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
OPTIONAL = {"breakdown", "outputs_checked"}


def _keys_ok(res: dict, trace: bool):
    keys = list(res)
    assert keys[:5] == REQUIRED
    assert keys[-1] == "checks"
    assert set(keys[5:-1]) <= OPTIONAL
    assert ("breakdown" in res) == trace
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    json.dumps(res)


@pytest.mark.parametrize("workload", ["pairs32.and3", "pairs64.uniform"])
def test_untraced_run(workload, capsys):
    res = tiny_run(workload)
    _keys_ok(res, False)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 2 and res["outputs_checked"] >= 2
    # no peak memory on the CPU; the rest of the end-to-end metrics
    assert set(res["metrics"]) == {"records_per_s", "call_p95_ms", "setup_s"}
    assert res["checks"] == {"key_mismatch": {"value": 0, "limit": 0},
                             "value_mismatch": {"value": 0, "limit": 0}}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2:] == ["key_mismatch 0 limit 0", "value_mismatch 0 limit 0"]
    assert not harness.banned_modules()


def test_traced_run():
    res = tiny_run("pairs32.uniform", trace=True)
    _keys_ok(res, True)
    assert res["correct"]
    # no device on the CPU: the device's readers stay silent, and no
    # share is ever reported as 0
    assert set(res["metrics"]) == {"host_reads_per_sort"}
    assert res["metrics"]["host_reads_per_sort"]["value"] >= 2
    assert res["device"]["busy_s"] == 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_window_keeps_a_drawn_and_the_last_output_of_each_input():
    calls = []

    def call(inp):
        calls.append(inp)
        return {"keys": inp["keys"].clone()}
    inputs = [{"keys": torch.arange(4)}, {"keys": torch.arange(5)}]
    w = harness.timed_window(call, inputs, 0.05, 3, torch.device("cpu"))
    assert len(w.walls) == len(calls) >= 2
    assert calls[0] is inputs[0] and calls[1] is inputs[1]
    assert sorted(w.kept) == [0, 1]
    assert all(1 <= len(v) <= 2 for v in w.kept.values())
    assert w.seconds >= 0.05


def test_a_rehearsal_runs_its_least_number_of_calls_and_keeps_alike():
    """Set-up runs the window's loop for ``min_calls`` calls, keeping the
    outputs of the same calls as the timed window will."""
    inputs = [{"keys": torch.arange(4)}, {"keys": torch.arange(5)}]

    def call(inp):
        return {"keys": inp["keys"].clone()}
    n = len(inputs) * (harness.EARLY_CALLS + 1)
    w = harness.timed_window(call, inputs, 0.0, 11, torch.device("cpu"),
                             min_calls=n)
    assert len(w.walls) == n
    assert all(len(v) == 2 for v in w.kept.values())


def test_the_run_prints_what_the_host_did_in_the_window(capsys):
    res = tiny_run("pairs64.and3")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    host = [x["window_host"] for x in lines if "window_host" in x]
    assert len(host) == 1
    assert host[0]["calls"] == res["attempted"]
    assert host[0]["max_ms"] >= host[0]["median_ms"] > 0
    assert 0 <= host[0]["slow_calls"] < host[0]["calls"]
    parts = [x["setup_parts_s"] for x in lines if "setup_parts_s" in x][0]
    assert "rehearsal" in parts


def _run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "sortbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_py_refuses_without_a_card():
    p = _run_py(ROOT, "--workload", "pairs32.uniform", "--seed",
                str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_a_bare_checkout_prints_no_result(tmp_path):
    """With only BENCHMARK.json and sortbench/, the program is missing: a
    run fails before any result, on the card as here."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from sortbench import harness\n"
            "s = harness.load_spec('.', 'pairs32.uniform')\n"
            "s.config = dict(s.config, records=1000)\n"
            "print(harness.run(s, 1, 0.1, False, 'cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "repro_torch" in p.stderr
    assert "correct" not in p.stdout
    p = _run_py(tmp_path, "--workload", "pairs32.uniform", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and '"correct"' not in p.stdout
