"""Shared model building blocks: initializers, norms, RoPE, activations
(port of `repro.models.common`).

Parameters are plain dicts of tensors; a stack of layers is a per-layer
list of dicts (the JAX package stacks them along a leading L axis for
`lax.scan`). Initializers draw from an explicit `torch.Generator`; the
numbers differ from `jax.random` for the same seed, so cross-package tests
convert the JAX params instead (repro_torch.convert).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], device,
               scale: float | None = None) -> Tensor:
    """Truncated-normal (±2σ) fan-in init, fan_in = shape[-2]."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def embed_init(gen: torch.Generator, shape: Sequence[int], device) -> Tensor:
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return t.mul_(0.02)


def zeros_init(shape: Sequence[int], device) -> Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def ones_init(shape: Sequence[int], device) -> Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def layernorm(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """f32 inside, cast back; the biased variance, as `jnp.var`."""
    dt = x.dtype
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


def norm_params(cfg, device) -> dict:
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": ones_init((d,), device)}
    return {"scale": ones_init((d,), device), "bias": zeros_init((d,), device)}


def apply_norm(params: dict, x: Tensor, cfg) -> Tensor:
    if "bias" in params:
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE — interleaved-pair layout (pairs (2i, 2i+1)), the repo's own layout;
# it is not the rotate-half layout of HF Qwen2.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]               # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    if name in ("silu", "swish"):
        return F.silu
    if name in ("gelu", "gelu_mlp"):
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")
