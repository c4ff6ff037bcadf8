"""qwen2-7b: dense 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 —
GQA with QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("qwen2-7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        act="silu",
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671; hf",
    )


@register_smoke("qwen2-7b")
def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-7b-smoke",
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
        d_ff=144, vocab_size=256,
    )
