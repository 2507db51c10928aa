"""Model configuration schema for every assigned architecture, the same
data as the reference's ``repro.configs.base``.

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
vlm / audio).  Family-specific fields default to "off".  configs/<arch>.py
instantiates the exact published shape plus a reduced smoke variant.
``param_count`` / ``active_param_count`` return the reference's integers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // num_heads
    qk_norm: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm_np (non-parametric)
    rope_theta: float = 500_000.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    expert_sharding: str = "tp"  # tp: shard expert FFN width | ep: shard expert axis

    # --- SSM (mamba1/mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # mamba2 only
    ssm_version: int = 0  # 1 | 2
    ssm_chunk: int = 256  # chunked-scan length

    # --- hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # --- attention variants ---
    sliding_window: int = 0  # 0 = full causal

    # --- VLM: one cross-attention layer after every (segment-1) self layers
    cross_attn_segment: int = 0  # e.g. 5 => [4 self, 1 cross] repeating
    num_image_tokens: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frame-embedding length
    max_target_positions: int = 0

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    # ---- derived ----
    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        mlp = 3 * d * f
        if self.family == "moe":
            mlp *= self.num_experts
            mlp += d * self.num_experts  # router
        ssm = 0
        if self.ssm_version:
            di, s = self.d_inner, self.ssm_state
            if self.ssm_version == 1:
                ssm = 2 * d * di + di * (2 * s + 1) + di * self.ssm_conv + 2 * di + di * d
            else:
                g = 2 * s  # B and C, single group
                ssm = d * (2 * di + g + self.ssm_heads) + di * self.ssm_conv + di * d + 3 * self.ssm_heads
        n_attn_layers, n_mlp_layers, n_ssm_layers = self.num_layers, self.num_layers, 0
        if self.family == "ssm":
            n_attn_layers = n_mlp_layers = 0
            n_ssm_layers = self.num_layers
        elif self.family == "hybrid":
            n_ssm_layers = self.num_layers
            n_attn_layers = 1  # shared (weight-tied) attention block
            n_mlp_layers = 1
        total = n_attn_layers * attn + n_mlp_layers * mlp + n_ssm_layers * ssm
        total += v * d  # tied embedding/output
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp)
            total += self.num_layers * attn  # decoder cross-attention
        if self.cross_attn_segment:
            n_cross = self.num_layers // self.cross_attn_segment
            total = (self.num_layers - n_cross) * attn + self.num_layers * mlp + n_cross * attn + v * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = 3 * d * f
        total = self.param_count()
        total -= self.num_layers * dense_mlp * self.num_experts
        total += self.num_layers * dense_mlp * self.experts_per_token
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
