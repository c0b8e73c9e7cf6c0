"""Qwen3-30B-A3B: 128-expert top-8 MoE. [hf:Qwen/Qwen3-30B-A3B; hf]

The paper's technique is CORE here: expert dispatch is one d=7 counting pass.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, num_experts=128, top_k=8,
    rope_theta=1e6, optimizer="adamw", fsdp_params=True, seq_shard_activations=True,
)
