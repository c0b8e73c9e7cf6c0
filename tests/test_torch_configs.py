"""The port's model configs against the reference's, field for field.

``repro_torch.configs`` keeps its own copy of the ten architecture files
and of the schema; every full and smoke config must equal the reference's
(``dataclasses.asdict``), and the counterparts of the reference's config
tests hold for the port's copies.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402


def test_arch_registry_equals_reference():
    assert tcfg.ARCHS == jcfg.ARCHS
    assert set(tcfg.SHAPES) == set(jcfg.SHAPES)
    for name, shape in tcfg.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jcfg.SHAPES[name])
        assert shape.tokens == jcfg.SHAPES[name].tokens


@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_configs_equal_reference(arch):
    for get_t, get_j in ((tcfg.get_config, jcfg.get_config),
                         (tcfg.get_smoke_config, jcfg.get_smoke_config)):
        got, want = get_t(arch), get_j(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("padded_vocab", "n_heads_padded", "n_kv_padded",
                     "is_moe", "has_attention", "has_ssm", "d_inner",
                     "ssm_heads"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert ([s.name for s in tcfg.shapes_for(got)]
                == [s.name for s in jcfg.shapes_for(want)])
    # the hyphenated alias resolves the same way
    assert tcfg.get_config(arch.replace("_", "-")) == tcfg.get_config(arch)


@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_full_config_is_exact(arch):
    """The port's full configs carry the exact published numbers."""
    cfg = tcfg.get_config(arch)
    spec = {
        "qwen3_moe_30b_a3b": (48, 2048, 32, 4, 768, 151936, 128, 8),
        "kimi_k2_1t_a32b": (61, 7168, 64, 8, 2048, 163840, 384, 8),
        "musicgen_medium": (48, 1536, 24, 24, 6144, 2048, 0, 0),
        "internlm2_1_8b": (24, 2048, 16, 8, 8192, 92544, 0, 0),
        "deepseek_67b": (95, 8192, 64, 8, 22016, 102400, 0, 0),
        "phi4_mini_3_8b": (32, 3072, 24, 8, 8192, 200064, 0, 0),
        "deepseek_7b": (30, 4096, 32, 32, 11008, 102400, 0, 0),
        "hymba_1_5b": (32, 1600, 25, 5, 5504, 32001, 0, 0),
        "mamba2_1_3b": (48, 2048, 0, 0, 0, 50280, 0, 0),
        "internvl2_26b": (48, 6144, 48, 8, 16384, 92553, 0, 0),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab, cfg.num_experts, cfg.top_k)
    assert got == spec
    if arch == "mamba2_1_3b":
        assert cfg.ssm_state == 128
    if arch == "hymba_1_5b":
        assert cfg.ssm_state == 16 and cfg.supports_long_context
    names = [s.name for s in tcfg.shapes_for(cfg)]
    if arch in ("mamba2_1_3b", "hymba_1_5b"):
        assert "long_500k" in names
    else:
        assert "long_500k" not in names


def test_param_counts_roughly_match_billing():
    expect = {"kimi_k2_1t_a32b": (0.9e12, 1.2e12),
              "deepseek_67b": (60e9, 72e9),
              "deepseek_7b": (6e9, 8e9),
              "qwen3_moe_30b_a3b": (28e9, 33e9),
              "mamba2_1_3b": (1.1e9, 1.6e9),
              "phi4_mini_3_8b": (3.4e9, 4.6e9),
              "internlm2_1_8b": (1.6e9, 2.2e9)}
    for arch, (lo, hi) in expect.items():
        n = tcfg.get_config(arch).param_count()
        assert lo < n < hi, (arch, n)


def test_torch_dtype_maps_config_strings():
    assert tcfg.torch_dtype("bfloat16") is torch.bfloat16
    assert tcfg.torch_dtype("float32") is torch.float32
    assert tcfg.torch_dtype(tcfg.get_config("qwen3_moe_30b_a3b")) \
        is torch.bfloat16
    assert tcfg.torch_dtype(tcfg.get_smoke_config("mamba2_1_3b")) \
        is torch.float32
    with pytest.raises(ValueError, match="unsupported model dtype"):
        tcfg.torch_dtype("int8")
