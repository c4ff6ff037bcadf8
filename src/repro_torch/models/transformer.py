"""Decoder layer assembly, dense family (port of
`repro.models.transformer`).

Layers run one at a time from a per-layer list of param dicts (the JAX
package scans stacked params). `BuildPlan` keeps the facts the dense path
reads: the KV-cache dtype and the prefill cache length. The port runs on
one device, so there is no TP head or vocab padding (the JAX plan's tp=1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import (cache_insert, cache_prefill,
                                          decode_attend, flash_attention,
                                          head_to_kv_map, init_kv_cache,
                                          qkv_project)
from repro_torch.models.common import apply_norm, apply_rope, norm_params

Tensor = torch.Tensor


@dataclass(frozen=True)
class BuildPlan:
    cache_dtype: torch.dtype = torch.bfloat16
    # prefill cache capacity (0 -> prompt length); decode callers set
    # prompt+max_new so decode continues without ring eviction
    prefill_cache_len: int = 0

    def replace(self, **kw) -> "BuildPlan":
        return dataclasses.replace(self, **kw)


def check_dense(cfg) -> None:
    if (cfg.family != "dense" or cfg.attn_free or cfg.moe is not None
            or cfg.parallel_ssm_heads or cfg.cross_attn is not None
            or cfg.norm_type != "rmsnorm"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet: only the dense transformer is")


def init_layer(gen: torch.Generator, cfg, device) -> dict:
    check_dense(cfg)
    return {"ln1": norm_params(cfg, device),
            "attn": attn_mod.init_attn(gen, cfg, device),
            "ln2": norm_params(cfg, device),
            "mlp": mlp_mod.init_mlp(gen, cfg, device)}


def _hmap(cfg, device):
    return head_to_kv_map(cfg.n_heads, cfg.n_heads, cfg.n_kv_heads, device)


# ---------------------------------------------------------------------------
# full sequence (calibration / eval / prefill)
# ---------------------------------------------------------------------------

def _self_attention_full(p, x, cfg, plan, make_cache: bool, taps=None,
                         quantize_cb=None):
    ap = p["attn"]
    if taps is not None:
        taps["attn_in"] = x                   # feeds wq / wk / wv
        if quantize_cb is not None:
            ap = {**ap, **quantize_cb("attn_in")}
    q, k, v = qkv_project(ap, x)
    B, T = x.shape[:2]
    if cfg.causal:
        pos = torch.arange(T, device=x.device).expand(B, T)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, _hmap(cfg, x.device),
                        causal=cfg.causal, window=cfg.sliding_window)
    if taps is not None:
        taps["wo_in"] = o.reshape(B, T, -1)   # feeds wo (Hp*hd, d)
        if quantize_cb is not None:
            ap = {**ap, **quantize_cb("wo_in")}
    cache = None
    if make_cache:
        if cfg.sliding_window:
            clen = max(cfg.sliding_window, plan.prefill_cache_len)
        else:
            clen = max(plan.prefill_cache_len, T)
        cache = init_kv_cache(B, clen, cfg.n_kv_heads, cfg.resolved_head_dim,
                              plan.cache_dtype, x.device)
        cache = cache_prefill(cache, k, v)
    return attn_mod.out_project(ap, o), cache


def layer_full(p: dict, x: Tensor, cfg, plan: BuildPlan, make_cache: bool,
               taps=None, quantize_cb=None):
    """One layer over a full sequence. Returns (x, cache_or_None).

    `quantize_cb` (calibration only, requires `taps`) is called once per
    activation tap right after the tap is recorded and before the weights
    it feeds are applied; it returns replacement (dequantized) leaves, so
    the rest of this forward runs on the already-quantized sub-blocks —
    the staged one-forward-per-layer calibration walk."""
    check_dense(cfg)
    xn = apply_norm(p["ln1"], x, cfg)
    a_out, cache = _self_attention_full(p, xn, cfg, plan, make_cache, taps,
                                        quantize_cb)
    x = x + a_out
    xn = apply_norm(p["ln2"], x, cfg)
    x = x + mlp_mod.apply_mlp(p["mlp"], xn, cfg, taps=taps,
                              quantize_cb=quantize_cb)
    return x, cache


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def layer_decode(p: dict, x: Tensor, cfg, plan: BuildPlan, kv_cache,
                 pos: int):
    """x: (B, 1, d) at absolute position `pos`. Returns (x, kv_cache); the
    cache is updated in place."""
    check_dense(cfg)
    xn = apply_norm(p["ln1"], x, cfg)
    q, k, v = qkv_project(p["attn"], xn)
    B = x.shape[0]
    posb = torch.full((B, 1), int(pos), device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    kv_cache = cache_insert(kv_cache, k, v, pos)
    o = decode_attend(q, kv_cache, _hmap(cfg, x.device), pos=pos,
                      window=cfg.sliding_window)
    x = x + attn_mod.out_project(p["attn"], o)
    xn = apply_norm(p["ln2"], x, cfg)
    return x + mlp_mod.apply_mlp(p["mlp"], xn, cfg), kv_cache
