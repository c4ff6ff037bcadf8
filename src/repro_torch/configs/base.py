"""Model/shape/run configuration dataclasses (the port's own copy of
`repro.configs.base`; pure dataclasses, no framework imports)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


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


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes (identical across all ten archs).
TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class RunConfig:
    """Everything the training launcher needs besides the model itself (the
    JAX package's RunConfig, field for field; the port's trainer reads the
    training, distributed-optimization and checkpointing fields)."""
    arch: str
    shape: str = "train_4k"
    multi_pod: bool = False
    microbatches: int = 1         # gradient accumulation steps
    remat: bool = True
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # distributed-optimization knobs
    grad_compression: str = "none"   # none | int8_ef
    # checkpointing / fault tolerance
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    async_ckpt: bool = True
    keep_ckpts: int = 3
    # quantization (COMQ) defaults — paper §4: K=3..4, lambda<=1
    quant_bits: int = 4
    quant_granularity: str = "per_channel"   # per_channel | per_layer
    quant_order: str = "greedy"              # greedy | cyclic
    quant_sweeps: int = 3
    quant_lambda: float = 0.9
