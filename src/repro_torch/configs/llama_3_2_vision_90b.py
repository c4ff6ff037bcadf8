"""llama-3.2-vision-90b: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — a gated cross-attention layer over the image every 5th
layer. The vision frontend is a stub: callers hand over precomputed patch
embeddings (1601 tokens of width 1280), projected in the model.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import CrossAttnConfig, ModelConfig


@register("llama-3.2-vision-90b")
def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,              # 80 self-attn + 20 cross-attn
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cross_attn=CrossAttnConfig(every=5, n_vision_tokens=1601,
                                   vision_dim=1280),
        act="silu",
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )


@register_smoke("llama-3.2-vision-90b")
def smoke() -> ModelConfig:
    return full().replace(
        name="llama-3.2-vision-90b-smoke",
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        cross_attn=CrossAttnConfig(every=5, n_vision_tokens=17, vision_dim=32),
    )
