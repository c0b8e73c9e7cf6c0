"""Assigned architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port's copy of ``repro.configs``: the same ten configs with their
published numbers, and the same reduced smoke configs.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                     shapes_for, torch_dtype)

ARCHS = [
    "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "musicgen_medium",
    "internlm2_1_8b", "deepseek_67b", "phi4_mini_3_8b", "deepseek_7b",
    "hymba_1_5b", "mamba2_1_3b", "internvl2_26b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: tiny width/depth/vocab for CPU smoke tests."""
    cfg = get_config(arch)
    updates = dict(
        n_layers=2, d_model=64, vocab=256, vocab_pad_multiple=16,
        rope_theta=1e4, dtype="float32",
    )
    if cfg.has_attention:
        updates.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                       head_dim=16)
    if cfg.is_moe:
        updates.update(num_experts=8, top_k=2, d_ff=32)
    elif cfg.d_ff:
        updates.update(d_ff=128)
    if cfg.has_ssm:
        updates.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        updates.update(attn_window=8, global_attn_layers=(0,))
    if cfg.frontend == "vision_patches":
        updates.update(num_patches=4)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **updates)


__all__ = ["ARCHS", "get_config", "get_smoke_config", "ModelConfig",
           "ShapeConfig", "SHAPES", "shapes_for", "torch_dtype"]
