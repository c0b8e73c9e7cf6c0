"""``correct`` comes out false when the timed path is broken: the run is
driven whole on the CPU (the harness's look for a card skipped) with a
fault planted under it, and with the reference's control in the
program's place."""
import pytest

from sortbench import faults, harness

from ._tiny import tiny_run, tiny_spec

CELLS = ["pairs32.uniform", "pairs32.and3", "pairs64.uniform",
         "pairs64.and3"]


def _entry(workload):
    return harness.load_module("entries",
                               tiny_spec(workload).config["entry"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(workload, fault):
    call = faults.FAULTS[fault](_entry(workload).call)
    res = tiny_run(workload, seed=2**32 + 3, call=call)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


#: records in a control run: the control orders by the high half of each
#: key, so it has to meet keys whose high halves are equal; 2^20 uniform
#: 64-bit keys hold ~128 such pairs (the cells' 2^27 hold ~2^21)
CONTROL_RECORDS = 1 << 20


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    ref = harness.load_module("references",
                              tiny_spec(workload).config["reference"])
    res = tiny_run(workload, seed=2**31 + 99, call=ref.control,
                   records=CONTROL_RECORDS)
    assert res["correct"] is False
    assert res["checks"]["key_mismatch"]["value"] > 0
    assert res["checks"]["value_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(workload):
    assert tiny_run(workload, seed=2**33 + 1)["correct"] is True
