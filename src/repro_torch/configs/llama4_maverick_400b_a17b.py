"""llama4-maverick-400b-a17b: MoE 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, 128 experts top-1 (+ shared expert), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig, MoEConfig


@register("llama4-maverick-400b-a17b")
def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(n_experts=128, top_k=1),
        act="silu",
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )


@register_smoke("llama4-maverick-400b-a17b")
def smoke() -> ModelConfig:
    return full().replace(
        name="llama4-maverick-400b-a17b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=288, moe=MoEConfig(n_experts=4, top_k=1),
    )
