"""hymba-1.5b: hybrid 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig, SSMConfig


@register("hymba-1.5b")
def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        sliding_window=1024,   # hymba uses SWA for most layers
        parallel_ssm_heads=True,
        ssm=SSMConfig(state_dim=16, expand=2, conv_width=4),
        act="silu",
        source="arXiv:2411.13676; hf",
    )


@register_smoke("hymba-1.5b")
def smoke() -> ModelConfig:
    return full().replace(
        name="hymba-1.5b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=257, sliding_window=16,
        ssm=SSMConfig(state_dim=4, expand=2, conv_width=4),
    )
