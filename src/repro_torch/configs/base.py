"""Model/shape/run configuration dataclasses (the port's own copy of
`repro.configs.base`; pure dataclasses, no framework imports)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective-state head (hymba) parameters."""
    state_dim: int = 16
    expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 'Finch' parameters."""
    head_dim: int = 64
    decay_lora: int = 64
    gate_lora: int = 64
    token_shift_lora: int = 32


@dataclass(frozen=True)
class CrossAttnConfig:
    """Interleaved cross-attention (llama-3.2-vision style)."""
    every: int = 5
    n_vision_tokens: int = 1601
    vision_dim: int = 1280


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | vlm | audio | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0   # 0 -> full causal attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    act: str = "silu"            # silu (gated) | gelu (gated) | gelu_mlp
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    attn_free: bool = False
    parallel_ssm_heads: bool = False
    causal: bool = True
    # numerics
    param_dtype: str = "float32"  # master copy dtype
    compute_dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

