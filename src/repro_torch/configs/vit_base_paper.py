"""vit-base-16: the COMQ paper's own architecture (ViT-B/16, Dosovitskiy
et al.) — encoder-only, the primary quantization target of the paper's
Tab. 1/2. The patch frontend is a stub: callers hand over precomputed
patch embeddings (196 patches + cls = 197 tokens)."""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig


@register("vit-base-16")
def full() -> ModelConfig:
    return ModelConfig(
        name="vit-base-16",
        family="encoder",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=1000,          # classifier head width (ImageNet classes)
        act="gelu_mlp",
        norm_type="layernorm",
        causal=False,
        source="arXiv:2010.11929 (paper's own eval arch)",
    )


@register_smoke("vit-base-16")
def smoke() -> ModelConfig:
    return full().replace(
        name="vit-base-16-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=16,
    )
