"""deepseek-67b: dense 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("deepseek-67b")
def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        act="silu",
        rope_theta=10_000.0,
        source="arXiv:2401.02954; hf",
    )


@register_smoke("deepseek-67b")
def smoke() -> ModelConfig:
    return full().replace(
        name="deepseek-67b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=320,
    )
