"""rwkv6-7b 'Finch': ssm-family 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — data-dependent decay linear attention.  [arXiv:2404.05892; hf]"""
from repro_torch.configs import register, register_smoke
from repro_torch.configs.base import ModelConfig, RWKVConfig


@register("rwkv6-7b")
def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,              # wkv heads = d_model / rwkv.head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        attn_free=True,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64,
                        token_shift_lora=32),
        norm_type="layernorm",
        act="relu_sq",           # rwkv channel-mix uses squared relu
        source="arXiv:2404.05892; hf",
    )


@register_smoke("rwkv6-7b")
def smoke() -> ModelConfig:
    return full().replace(
        name="rwkv6-7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8,
                        token_shift_lora=4),
    )
