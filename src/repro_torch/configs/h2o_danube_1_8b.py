"""h2o-danube-1.8b: dense 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("h2o-danube-1.8b")
def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,
        act="silu",
        rope_theta=10_000.0,
        source="arXiv:2401.16818; hf",
    )


@register_smoke("h2o-danube-1.8b")
def smoke() -> ModelConfig:
    return full().replace(
        name="h2o-danube-1.8b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=32,
    )
