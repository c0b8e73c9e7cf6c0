"""The harness finds every configuration, mix, entry, reference and metric
of ``BENCHMARK.json`` by name, and the file keeps to its contract's
shape."""
import json
import re

import pytest

from sortbench import harness

from ._tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "sortbench/run.py"]
    assert BENCH["paths"] == ["sortbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_found_by_name(workload):
    spec = harness.load_spec(ROOT, workload)
    assert spec.cell["chips"] == 1
    assert spec.traffic["columns"]["keys"]["dist"] in ("uniform", "and",
                                                        "zipf")
    assert list(spec.config["columns"]) == ["keys", "values"]
    harness.load_module("entries", spec.config["entry"]).call
    ref = harness.load_module("references", spec.config["reference"])
    assert callable(ref.reference) and callable(ref.control)
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("sortbench/")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no metric 'nope'"):
        harness.load_module("metrics", "nope")
    with pytest.raises(KeyError):
        harness.load_spec(ROOT, "no.such.cell")


def test_a_metric_is_read_unless_its_workloads_leave_the_cell_out():
    cell = {"name": "x.y"}
    e2e = [{"name": "a"}, {"name": "b", "workloads": ["other"]}]
    per = [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b",
                                         "workloads": ["other"]},
           {"name": "r", "moves": "b", "workloads": ["x.y"]}]
    spec = harness.Spec(cell, {}, {}, e2e, per)
    assert [m["name"] for m in spec.end_to_end] == ["a"]
    assert [m["name"] for m in spec.per_layer] == ["p", "r"]
