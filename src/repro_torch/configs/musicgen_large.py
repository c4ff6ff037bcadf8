"""musicgen-large: audio 48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. The EnCodec frontend is a
stub: callers hand over frame-token ids. [arXiv:2306.05284; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("musicgen-large")
def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        act="gelu_mlp",           # musicgen uses a plain (non-gated) GELU MLP
        norm_type="layernorm",
        source="arXiv:2306.05284; hf",
    )


@register_smoke("musicgen-large")
def smoke() -> ModelConfig:
    return full().replace(
        name="musicgen-large-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128,
    )
