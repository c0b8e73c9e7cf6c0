"""MusicGen-medium decoder over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub (token ids over vocab 2048);
codebook interleaving is out of scope. n_heads=24 is not divisible by the
16-way model axis -> attention weights replicate, FFN shards (see sharding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, frontend="audio_tokens",
    head_pad_to=32, kv_pad_to=32,
)
