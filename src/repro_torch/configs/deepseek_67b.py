"""DeepSeek-67B dense llama-arch GQA. [arXiv:2401.02954; hf]

95 layers: the scan-stacked block representation keeps the dry-run HLO O(1)
in depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, rope_theta=1e4, fsdp_params=True,
)
