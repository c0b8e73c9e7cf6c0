"""The traffic generator: the same seed gives the same inputs."""
import pytest
import torch

from sortbench import generate

def _conf(records=5000, keys="uint32", values="uint32"):
    return {"records": records, "columns": {"keys": keys, "values": values}}


def _mix(keys):
    return {"columns": {"keys": keys, "values": {"dist": "uniform"}}}


CONF = _conf()
MIXES = [_mix({"dist": "uniform"}), _mix({"dist": "and", "ands": 3}),
         {"columns": {"keys": {"dist": "zipf", "a": 1.5}}},
         _mix({"dist": "uniform", "high": 384}),
         _mix({"dist": "zipf", "a": 1.2, "n": 384})]


def _bits(t):
    return t.view({torch.uint32: torch.int32,
                   torch.uint64: torch.int64}.get(t.dtype, t.dtype))


@pytest.mark.parametrize("dtype", ["uint32", "int64", "uint64", "int32"])
@pytest.mark.parametrize("mix", range(len(MIXES)))
def test_same_seed_same_inputs(dtype, mix):
    conf = _conf(keys=dtype, values=dtype)
    seed = 2**31 + 12345          # beyond 32 signed bits
    a = generate.make_inputs(conf, MIXES[mix], seed, "cpu")
    b = generate.make_inputs(conf, MIXES[mix], seed, "cpu")
    c = generate.make_inputs(conf, MIXES[mix], seed + 1, "cpu")
    assert len(a) == 2
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == getattr(torch, dtype)
            assert x[k].numel() == 5000
            assert torch.equal(_bits(x[k]), _bits(y[k]))
            assert not torch.equal(_bits(x[k]), _bits(z[k]))
    assert not torch.equal(_bits(a[0]["keys"]), _bits(a[1]["keys"]))


def test_and3_bit_density():
    conf = _conf(200_000, "int64")
    keys = generate.make_inputs(conf, MIXES[1], 7, "cpu")[0]["keys"]
    ones = sum(((keys >> b) & 1).sum().item() for b in range(64))
    assert abs(ones / (64 * keys.numel()) - 1 / 16) < 0.002
    assert (keys < 0).any()       # the sign bit is drawn like any other


def test_uniform_covers_the_range():
    conf = _conf(100_000)
    keys = generate.make_inputs(conf, MIXES[0], 3, "cpu")[0]["keys"]
    image = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert image.max() > 0xF0000000 and image.min() < 0x10000000
    assert ((image >> 31) & 1).float().mean().item() == pytest.approx(0.5,
                                                                      abs=0.01)


def test_zipf_law():
    conf = _conf(100_000, "int64")
    keys = generate.make_inputs(conf, MIXES[2], 5, "cpu")[0]["keys"]
    assert keys.min().item() == 1
    # P(1) = 1 / zeta(1.5) = 0.383
    assert (keys == 1).float().mean().item() == pytest.approx(0.383,
                                                              abs=0.01)


def test_input_bytes():
    inp = generate.make_inputs(CONF, MIXES[0], 1, "cpu")[0]
    assert generate.input_bytes(inp) == 5000 * 8
    inp = generate.make_inputs(_conf(keys="int64"), MIXES[0], 1, "cpu")[0]
    assert generate.input_bytes(inp) == 5000 * 12


def test_bounded_bucket_ids():
    """``high``: ids uniform in [0, high), every bucket drawn."""
    conf = _conf(100_000, "int32")
    keys = generate.make_inputs(conf, MIXES[3], 9, "cpu")[0]["keys"]
    assert keys.dtype == torch.int32
    assert keys.min().item() == 0 and keys.max().item() == 383
    counts = torch.bincount(keys, minlength=384).float()
    assert counts.min() > 0.7 * counts.mean()


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64"])
def test_zipf_over_n_buckets(dtype):
    """``n``: ranks 1..n drawn by the law truncated at n, held as rank - 1."""
    conf = _conf(200_000, dtype)
    keys = generate.make_inputs(conf, MIXES[4], 4, "cpu")[0]["keys"]
    ids = _bits(keys).to(torch.int64)
    assert ids.min().item() == 0 and ids.max().item() <= 383
    p = torch.arange(1, 385, dtype=torch.float64).pow(-1.2)
    share = (ids == 0).double().mean().item()
    assert share == pytest.approx((p[0] / p.sum()).item(), abs=0.005)


def test_a_column_the_mix_leaves_out_is_uniform():
    conf = {"records": 100_000, "columns": {"keys": "int64", "ids": "int32"}}
    inp = generate.make_inputs(conf, MIXES[2], 6, "cpu")[0]
    assert list(inp) == ["keys", "ids"]
    assert (inp["ids"] < 0).float().mean().item() == pytest.approx(0.5,
                                                                    abs=0.01)


def test_a_mix_may_name_a_generator_module():
    seen = []

    class Mod:
        @staticmethod
        def make(config, traffic, gen, device):
            seen.append((traffic["generator"], gen.initial_seed()))
            return [{"keys": torch.zeros(3, dtype=torch.int64)}]

    def load_module(kind, name):
        assert kind == "generators"
        return Mod
    out = generate.make_inputs(CONF, {"generator": "own"}, 2**40, "cpu",
                               load_module)
    assert seen == [("own", 2**40)] and out[0]["keys"].numel() == 3
