"""InternVL2-26B: InternViT frontend (stub) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

input_specs() provides precomputed patch embeddings; the ViT is out of scope.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, rope_theta=1e6,
    frontend="vision_patches", num_patches=256, fsdp_params=True,
)
