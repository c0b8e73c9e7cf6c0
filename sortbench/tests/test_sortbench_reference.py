"""The plain reference against numpy's stable argsort, and its control."""
import numpy as np
import pytest
import torch

from sortbench import generate
from sortbench.references import stable_sort as ref

NP = {"uint32": np.uint32, "int64": np.int64, "uint64": np.uint64,
      "int32": np.int32, "uint16": np.uint16, "int16": np.int16,
      "uint8": np.uint8, "int8": np.int8}


def _np(t):
    return t.view(generate.SIGNED.get(t.dtype, t.dtype)).numpy().view(
        NP[str(t.dtype).split(".")[1]])


def _conf(records, dtype):
    return {"records": records, "columns": {"keys": dtype,
                                            "values": "int64"}}


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("dist", [{"dist": "uniform"},
                                  {"dist": "and", "ands": 3},
                                  {"dist": "zipf", "a": 1.2}])
def test_reference_is_numpy_stable_argsort(dtype, dist):
    conf = _conf(3000, dtype)
    inp = generate.make_inputs(conf, {"columns": {"keys": dist}}, 11,
                               "cpu")[0]
    want = np.argsort(_np(inp["keys"]), kind="stable")
    out = ref.reference(inp, conf)
    assert np.array_equal(_np(out["keys"]), _np(inp["keys"])[want])
    assert np.array_equal(out["values"].numpy(),
                          inp["values"].numpy()[want])
    assert ref.compare(out, ref.reference(inp, conf)) == {"key_mismatch": 0,
                                                    "value_mismatch": 0}


@pytest.mark.parametrize("dtype", ["uint32", "int64", "uint64", "int32"])
def test_control_breaks_the_order(dtype):
    # enough records that some keys share their high half (64-bit: ~128)
    conf = _conf(1 << 20, dtype)
    inp = generate.make_inputs(conf, {}, 3, "cpu")[0]
    got = ref.compare(ref.control(inp, conf), ref.reference(inp, conf))
    assert got["key_mismatch"] > 0 and got["value_mismatch"] > 0


def test_mismatch_of_a_missing_or_short_column():
    t = torch.arange(10)
    assert ref.mismatches(None, t) == 10
    assert ref.mismatches(t[:5], t) == 10
    assert ref.mismatches(t.to(torch.int32), t) == 10
