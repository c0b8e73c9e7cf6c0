"""Hymba-1.5B: parallel attention+mamba heads per block. [arXiv:2411.13676; hf]

Sliding-window attention everywhere except 3 global layers + SSM state =>
sub-quadratic: runs the long_500k decode cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    attn_window=1024, global_attn_layers=(0, 15, 31),
    supports_long_context=True,
)
