"""granite-moe-3b-a800m: MoE 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig, MoEConfig


@register("granite-moe-3b-a800m")
def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(n_experts=40, top_k=8),
        act="silu",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )


@register_smoke("granite-moe-3b-a800m")
def smoke() -> ModelConfig:
    return full().replace(
        name="granite-moe-3b-a800m-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=259, moe=MoEConfig(n_experts=4, top_k=2),
    )
