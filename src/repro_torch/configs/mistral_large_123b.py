"""mistral-large-123b: dense 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("mistral-large-123b")
def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        head_dim=128,
        act="silu",
        rope_theta=1_000_000.0,
        source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    )


@register_smoke("mistral-large-123b")
def smoke() -> ModelConfig:
    return full().replace(
        name="mistral-large-123b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
