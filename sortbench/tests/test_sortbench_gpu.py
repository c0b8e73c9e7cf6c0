"""On the card: a cell at a reduced size through the whole harness,
traced (the profiler's launch count held to the program's), the control
and each planted fault.  Marked ``gpu``; each test skips without a card,
deciding when it runs:

    python -m pytest -m gpu sortbench/tests
"""
import pytest
import torch

from sortbench import faults, harness

from ._tiny import tiny_spec

CELLS = ["pairs32.uniform", "pairs32.and3", "pairs64.uniform",
         "pairs64.and3"]
RECORDS = 1 << 22


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload, trace=False, call=None, seed=2**31 + 7):
    return harness.run(tiny_spec(workload, RECORDS), seed, 1.0, trace,
                       "cuda", call=call)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    _card()
    res = _run(workload, trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    assert {"kernel_device_ms", "plan_device_ms", "launches_per_sort",
            "fused_pass0_roofline", "sort_roofline"} <= set(m)
    assert 0 < m["fused_pass0_roofline"]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload):
    _card()
    ref = harness.load_module("references",
                              tiny_spec(workload).config["reference"])
    assert _run(workload, call=ref.control)["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_on_the_card(fault):
    _card()
    entry = harness.load_module("entries", "hybrid_sort")
    res = _run("pairs32.uniform", call=faults.FAULTS[fault](entry.call))
    assert res["correct"] is False
