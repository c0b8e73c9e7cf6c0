"""Architecture configuration schema for all assigned model families.

The port's own copy of ``repro.configs.base`` (pure data, field for field
the same), plus :func:`torch_dtype`, the one place where a config's
``dtype`` string becomes a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string ("bfloat16",
    "float32", "float16"), or of a ``ModelConfig``."""
    name = getattr(name, "dtype", name)
    if name not in _DTYPES:
        raise ValueError(f"unsupported model dtype {name!r}")
    return _DTYPES[name]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free
    n_kv_heads: int
    d_ff: int                     # dense FFN width (expert width for moe)
    vocab: int

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_dispatch: str = "sort"    # "sort" (paper technique) | "dense" (baseline)
    dispatch_groups: int = 1      # launcher sets to the data-shard count
    capacity_factor: float = 1.25

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (hymba): sliding-window attention everywhere except these layers
    attn_window: int = 0          # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()

    # TP head padding (Megatron-style): pad Q (and optionally KV) head counts
    # up to a model-axis multiple so attention shards instead of replicating.
    # Pad heads are zero-initialised AND output-masked — the math is exactly
    # the unpadded architecture (tested).
    head_pad_to: int = 0          # 0 = off; else padded Q head count
    kv_pad_to: int = 0            # 0 = off; else padded KV head count

    # misc
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"

    # modality frontends are stubs: input_specs() provides embeddings directly
    frontend: str = "none"        # none | audio_tokens | vision_patches
    num_patches: int = 0          # vlm: patch embeddings prepended per image

    # which input shapes apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    # large-model memory knobs (per-arch defaults; launcher may override)
    optimizer: str = "adamw"      # adamw | adafactor | adamw8bit
    remat: bool = True
    fsdp_params: bool = False     # storage-shard expert/ffn params over data
    scan_unroll: bool = False     # unroll the layer scan (cost-analysis fits)
    seq_shard_activations: bool = False  # sequence-parallel residual stream
    attention_impl: str = "naive"  # naive (materialised S^2) | flash (blockwise)
    flash_block: int = 512         # KV block for the flash path
    remat_policy: str = "full"     # full | save_block_io (keep collective
                                   # outputs: no re-all-reduce in backward)

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad_multiple)

    @property
    def n_heads_padded(self) -> int:
        return self.head_pad_to or self.n_heads

    @property
    def n_kv_padded(self) -> int:
        return self.kv_pad_to or self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def d_inner(self) -> int:     # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, l = self.d_model, self.n_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.has_attention:
            hq = self.n_heads * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            per_layer += d * hq * 2 + d * hkv * 2
        if self.has_ssm:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * ns + nh) + di * d + di  # in/out/conv-ish
        if self.is_moe:
            per_layer += self.num_experts * 3 * d * self.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d                      # norms
        return emb + l * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.num_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Sequence[ShapeConfig]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out
