"""Kimi K2: trillion-parameter MoE, 384 experts top-8. [arXiv:2501.kimi2; unverified]

1T params force the large-scale memory path: EP over model axis, FSDP storage
sharding over data, factored optimizer states. Expert dispatch = one d=9 pass.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840, num_experts=384, top_k=8,
    rope_theta=5e4, optimizer="adafactor", fsdp_params=True, seq_shard_activations=True,
)
