"""Architecture and shape configuration dataclasses and the registry.

A copy of the JAX package's ``configs/base.py`` (plain Python): the port
keeps its own so that it imports nothing of ``repro``. Only the fields
and properties the port's models read are documented here; the rest are
kept so a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    sliding_window: Optional[int] = None     # SWA window (tokens) or None
    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0                      # defaults to head_dim

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1                # layer l is MoE iff l % period == offset
    moe_layer_offset: int = 0
    first_dense_layers: int = 0              # first k layers always dense
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # hybrid (jamba): layer l is attention iff l % attn_layer_period == attn_layer_offset
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # vlm: layer l cross-attends to image tokens iff l % cross_attn_period == cross_attn_offset
    cross_attn_period: int = 0
    cross_attn_offset: int = 0
    num_image_tokens: int = 0

    norm_type: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "swiglu"                      # swiglu | gelu
    tie_embeddings: bool = False
    block_period: int = 1                    # layers stacked in super-blocks of this size

    def __post_init__(self):
        if self.use_mla:
            assert self.kv_lora_rank > 0
        if self.num_experts:
            assert self.experts_per_token > 0 and self.moe_d_ff > 0
        assert self.num_layers % self.block_period == 0, (self.name, "block period")

    @property
    def v_hd(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def num_blocks(self) -> int:
        return self.num_layers // self.block_period

    @property
    def d_inner(self) -> int:                # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, l: int) -> str:
        """Mixer kind for layer index l: 'attn' | 'ssm' | 'cross'."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_layer_period:
            return "attn" if l % self.attn_layer_period == self.attn_layer_offset else "ssm"
        if self.cross_attn_period and l % self.cross_attn_period == self.cross_attn_offset:
            return "cross"
        return "attn"

    def is_moe_layer(self, l: int) -> bool:
        if not self.num_experts or l < self.first_dense_layers:
            return False
        return l % self.moe_layer_period == self.moe_layer_offset

    def padded_vocab(self, multiple: int = 2048) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                                # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _pkg  # ensure arch modules imported
    _pkg.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from repro_torch import configs as _pkg
    _pkg.load_all()
    return dict(_REGISTRY)


# Shapes skipped per arch, as in the JAX package (its DESIGN.md
# §Arch-applicability): long_500k requires sub-quadratic attention; run
# only for ssm/hybrid/SWA.
SKIPPED_CELLS: dict[tuple[str, str], str] = {
    ("whisper-small", "long_500k"): "full attention enc-dec; no sub-quadratic path",
    ("stablelm-12b", "long_500k"): "pure full attention",
    ("llama3.2-3b", "long_500k"): "pure full attention",
    ("llama3-405b", "long_500k"): "pure full attention",
    ("qwen2-7b", "long_500k"): "pure full attention",
    ("deepseek-v2-lite-16b", "long_500k"): "MLA is full attention over latents",
    ("llama-3.2-vision-90b", "long_500k"): "pure full attention",
}


def cell_is_skipped(arch: str, shape: str) -> str | None:
    return SKIPPED_CELLS.get((arch, shape))
