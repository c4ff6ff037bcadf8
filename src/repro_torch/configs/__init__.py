"""Architecture registry (the port's copy of `repro.configs`).

Every architecture of the JAX package is registered: the dense GQA
transformers (qwen2-7b, deepseek-67b, mistral-large-123b,
h2o-danube-1.8b), the MoE family (granite-moe-3b-a800m,
llama4-maverick-400b-a17b), the hybrid hymba-1.5b, the attention-free
rwkv6-7b, the audio decoder musicgen-large, the VLM
llama-3.2-vision-90b and the encoder vit-base-16. Asking for another
name raises a KeyError that says so."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import (ALL_SHAPES, SHAPES, ModelConfig,
                                      ShapeConfig)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_smoke(name: str):
    def deco(fn):
        _SMOKE[name] = fn
        return fn
    return deco


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch; "
                       f"ported: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _SMOKE:
        raise KeyError(f"no ported smoke config for {arch!r}; ported: "
                       f"{sorted(_SMOKE)}")
    return _SMOKE[arch]()


def list_archs():
    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig):
    """Which assigned shapes are runnable for this arch (JAX's rule: an
    encoder has no decode, and the 500k decode needs bounded state)."""
    out = []
    for s in ALL_SHAPES:
        if cfg.family == "encoder" and s.kind == "decode":
            continue  # encoder-only: no autoregressive decode
        if s.name == "long_500k" and not _subquadratic(cfg):
            continue  # 500k decode needs bounded state
        out.append(s)
    return out


def _subquadratic(cfg: ModelConfig) -> bool:
    return bool(cfg.attn_free or cfg.ssm is not None or cfg.sliding_window)


# import for registration side effects
from repro_torch.configs import (  # noqa: E402,F401
    deepseek_67b, granite_moe_3b_a800m, h2o_danube_1_8b, hymba_1_5b,
    llama4_maverick_400b_a17b, llama_3_2_vision_90b, mistral_large_123b,
    musicgen_large, qwen2_7b, rwkv6_7b, vit_base_paper)

__all__ = ["ALL_SHAPES", "ModelConfig", "SHAPES", "ShapeConfig", "get_config",
           "get_smoke_config", "list_archs", "shapes_for"]
