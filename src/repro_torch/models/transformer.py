"""Layer assembly: the dense (and audio), MoE, hybrid (parallel SSM
heads), attention-free (RWKV6), VLM (gated cross-attention layers over the
image) and encoder (non-causal) families (port of
`repro.models.transformer`).

Layers run one at a time from a per-layer list of param dicts (the JAX
package scans stacked params; its VLM scans groups of `every`-1 self
layers and one cross layer, which the port holds as per-group lists).
`BuildPlan` keeps the facts the ported paths read: the KV-cache dtype or
its int8 form, the prefill cache length, the paged pool's code width,
the MoE token chunk and capacity rounding, and whether training
recomputes each layer in its backward pass (remat).
The port runs on one device, so there is no TP head, expert or vocab
padding (the JAX plan's tp=1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (cache_insert, cache_prefill,
                                          decode_attend, flash_attention,
                                          head_to_kv_map, init_kv_cache,
                                          paged_decode_attend, paged_insert,
                                          qkv_project)
from repro_torch.models.common import (apply_norm, apply_rope, norm_params,
                                       zeros_init)

Tensor = torch.Tensor


@dataclass(frozen=True)
class BuildPlan:
    cache_dtype: torch.dtype = torch.bfloat16
    cache_quant: bool = False    # int8 KV cache (per-entry absmax scales)
    # prefill cache capacity (0 -> prompt length); decode callers set
    # prompt+max_new so decode continues without ring eviction
    prefill_cache_len: int = 0
    # paged KV pool: 0 = pages in cache_dtype, 8 / 4 = integer page codes
    # with per-(layer, page, kv_head) scales (serve/kv_cache.py)
    kv_bits: int = 0
    # MoE: the token chunk of the non-calibration paths, and the multiple
    # the routing capacity is rounded up to
    moe_token_chunk: int = 4096
    moe_capacity_multiple: int = 1
    # the "data" process group of a sharded calibration walk: MoE routing
    # then counts capacity and bucket positions over the whole batch
    # (models/moe.py); None routes this process's tokens alone
    moe_group: Any = field(default=None, compare=False)
    # recompute each layer's activations in the backward pass (the JAX
    # plan's jax.checkpoint of the layer body): model.forward wraps every
    # layer in torch.utils.checkpoint while autograd records, and does
    # nothing under torch.no_grad (quantize, serve)
    remat: bool = True

    def experts_padded(self, cfg) -> int:
        return 0 if cfg.moe is None else cfg.moe.n_experts

    def replace(self, **kw) -> "BuildPlan":
        return dataclasses.replace(self, **kw)


FAMILIES = ("dense", "audio", "moe", "hybrid", "ssm", "vlm", "encoder")


def check_ported(cfg) -> None:
    """Raise for a configuration the port does not run: one whose family
    is not one of the JAX package's, or whose fields do not fit its family
    as the JAX configs define them — experts only in the MoE family,
    parallel SSM heads (with an SSMConfig) only in the hybrid one, RWKV
    (attention-free, with an RWKVConfig) only in the "ssm" one, cross-
    attention only in the VLM, non-causal attention only in the encoder
    (a layernorm one), rmsnorm or layernorm."""
    fam = cfg.family
    hybrid, rwkv = fam == "hybrid", fam == "ssm"
    encoder = fam == "encoder"
    if (fam not in FAMILIES
            or (fam == "moe") != (cfg.moe is not None)
            or hybrid != cfg.parallel_ssm_heads
            or (hybrid and cfg.ssm is None)
            or rwkv != cfg.attn_free or (rwkv and cfg.rwkv is None)
            or (fam == "vlm") != (cfg.cross_attn is not None)
            or encoder == cfg.causal
            or cfg.norm_type not in ("rmsnorm", "layernorm")
            or (encoder and cfg.norm_type != "layernorm")):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) with these fields is not "
            "a configuration the port runs: it runs the dense, audio, MoE, "
            "hybrid, RWKV, VLM and encoder families as the JAX package's "
            "configs define them")


def check_paged(cfg) -> None:
    """The paged KV pool serves the self-attention decoders only:
    parallel-SSM and attention-free layers carry a recurrent state per
    sequence and a VLM's cross layers the image's K/V, so hymba, RWKV and
    the VLM decode from the dense-cache `decode_step` (serve.Engine), as
    in the JAX package; an encoder does not decode."""
    check_ported(cfg)
    if (cfg.parallel_ssm_heads or cfg.attn_free
            or cfg.family in ("vlm", "encoder")):
        raise NotImplementedError(
            f"paged decode does not cover family={cfg.family!r} "
            "(parallel-SSM, attention-free and VLM archs use the dense-"
            "cache decode_step and serve.Engine)")


def init_layer(gen: torch.Generator, cfg, plan: BuildPlan, device) -> dict:
    check_ported(cfg)
    if cfg.attn_free:
        return {"ln1": norm_params(cfg, device),
                "tm": rwkv_mod.init_time_mix(gen, cfg, device),
                "ln2": norm_params(cfg, device),
                "cm": rwkv_mod.init_channel_mix(gen, cfg, device)}
    p = {"ln1": norm_params(cfg, device),
         "attn": attn_mod.init_attn(gen, cfg, device)}
    if cfg.parallel_ssm_heads:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device)
    p["ln2"] = norm_params(cfg, device)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, cfg, plan.experts_padded(cfg),
                                    device)
    else:
        p["mlp"] = mlp_mod.init_mlp(gen, cfg, device)
    return p


def init_cross_layer(gen: torch.Generator, cfg, device) -> dict:
    """A VLM cross-attention layer: `xattn` (its wk / wv read the projected
    image, width d_model) and the scalar gates gate_attn / gate_mlp, zero
    at init as in the JAX package (tanh(0) = 0: the layer starts as the
    identity)."""
    return {"ln1": norm_params(cfg, device),
            "xattn": attn_mod.init_attn(gen, cfg, device),
            "gate_attn": zeros_init((), device),
            "ln2": norm_params(cfg, device),
            "mlp": mlp_mod.init_mlp(gen, cfg, device),
            "gate_mlp": zeros_init((), device)}


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
                              plan.cache_dtype, x.device,
                              quantized=plan.cache_quant)
        cache = cache_prefill(cache, k, v)
    return attn_mod.out_project(ap, o), cache


def _ffn_full(p: dict, xn: Tensor, cfg, plan: BuildPlan, taps=None,
              quantize_cb=None):
    """The feed-forward block: (out, aux loss or None)."""
    if cfg.moe is not None:
        return moe_mod.apply_moe(p["moe"], xn, cfg, plan.experts_padded(cfg),
                                 plan.moe_token_chunk, taps=taps,
                                 quantize_cb=quantize_cb,
                                 capacity_multiple=plan.moe_capacity_multiple,
                                 group=plan.moe_group)
    return mlp_mod.apply_mlp(p["mlp"], xn, cfg, taps=taps,
                             quantize_cb=quantize_cb), None


def _rwkv_layer(p: dict, x: Tensor, cfg, state, taps=None,
                quantize_cb=None):
    """An attention-free layer from `state` (the zero state when None):
    time-mix on ln1(x), channel-mix on ln2 of the result. Returns (x,
    the new RWKVState); its shifts carry the last *normed* rows."""
    if state is None:
        state = rwkv_mod.init_rwkv_state(x.shape[0], cfg, device=x.device)
    h, new_tm, new_s = rwkv_mod.apply_time_mix(
        p["tm"], apply_norm(p["ln1"], x, cfg), cfg, state, taps=taps,
        quantize_cb=quantize_cb)
    x = x + h
    h, new_cm = rwkv_mod.apply_channel_mix(
        p["cm"], apply_norm(p["ln2"], x, cfg), cfg, state.x_cm, taps=taps,
        quantize_cb=quantize_cb)
    return x + h, rwkv_mod.RWKVState(new_tm, new_cm, new_s)


def layer_full(p: dict, x: Tensor, cfg, plan: BuildPlan, make_cache: bool,
               taps=None, quantize_cb=None, ssm_state=None, rwkv_state=None):
    """One layer over a full sequence. Returns (x, cache_or_None, aux,
    state): aux is the MoE load-balance loss, None for a dense layer;
    a parallel-SSM layer (hymba) runs its SSM branch from `ssm_state` (the
    zero state when None, as `forward` starts every layer) on the same
    normed input as attention, averages the two, and returns the branch's
    new state; an attention-free layer (RWKV) runs from `rwkv_state` (the
    zero state when None), makes no cache and returns its new RWKVState.
    The other families return None.

    `quantize_cb` (calibration only, requires `taps`) is called once per
    activation tap right after the tap is recorded and before the weights
    it feeds are applied; it returns replacement (dequantized) leaves, so
    the rest of this forward runs on the already-quantized sub-blocks —
    the staged one-forward-per-layer calibration walk."""
    check_ported(cfg)
    if cfg.attn_free:
        x, state = _rwkv_layer(p, x, cfg, rwkv_state, taps, quantize_cb)
        return x, None, None, state
    xn = apply_norm(p["ln1"], x, cfg)
    a_out, cache = _self_attention_full(p, xn, cfg, plan, make_cache, taps,
                                        quantize_cb)
    new_ssm = None
    if cfg.parallel_ssm_heads:
        if ssm_state is None:
            ssm_state = ssm_mod.init_ssm_state(x.shape[0], cfg,
                                               device=x.device)
        s_out, new_ssm = ssm_mod.apply_ssm(p["ssm"], xn, cfg, ssm_state,
                                           taps=taps, quantize_cb=quantize_cb)
        a_out = 0.5 * (a_out + s_out)
    x = x + a_out
    xn = apply_norm(p["ln2"], x, cfg)
    m_out, aux = _ffn_full(p, xn, cfg, plan, taps, quantize_cb)
    return x + m_out, cache, aux, new_ssm


def cross_layer_full(p: dict, x: Tensor, cfg, plan: BuildPlan, vision_kv,
                     taps=None, quantize_cb=None) -> Tensor:
    """A VLM cross layer over a full sequence: x + tanh(gate_attn) ·
    xattn(ln1(x), image) then x + tanh(gate_mlp) · mlp(ln2(x)). Taps
    xattn_q_in (feeds xattn.wq), xattn_wo_in (xattn.wo), mlp_in and
    down_in; `quantize_cb` as in `layer_full`. `vision_kv` is the
    (k, v) pair of `vision_kv_for_layer`; the attention over it is
    non-causal through the flash dispatch (Tq = T, or 1 in decode, over
    Tk = n_vision_tokens)."""
    cd = x.dtype
    xn = apply_norm(p["ln1"], x, cfg)
    xp = p["xattn"]
    if taps is not None:
        taps["xattn_q_in"] = xn
        if quantize_cb is not None:
            xp = {**xp, **quantize_cb("xattn_q_in")}
    k, v = vision_kv
    o = flash_attention(attn_mod._project_in(xp["wq"], xn, cd), k.to(cd),
                        v.to(cd), _hmap(cfg, x.device), causal=False)
    if taps is not None:
        taps["xattn_wo_in"] = o.reshape(*o.shape[:2], -1)
        if quantize_cb is not None:
            xp = {**xp, **quantize_cb("xattn_wo_in")}
    x = x + torch.tanh(p["gate_attn"]).to(cd) * attn_mod.out_project(xp, o)
    xn = apply_norm(p["ln2"], x, cfg)
    return x + torch.tanh(p["gate_mlp"]).to(cd) * mlp_mod.apply_mlp(
        p["mlp"], xn, cfg, taps=taps, quantize_cb=quantize_cb)


def vision_kv_for_layer(p_cross: dict, vision_embeds: Tensor):
    """The cross layer's K/V from the projected image (B, N, d): the dense
    xattn.wk / wv, which are never quantized (no tap feeds them)."""
    cd = vision_embeds.dtype
    xp = p_cross["xattn"]
    k = torch.einsum("bnd,dhk->bnhk", vision_embeds, xp["wk"].to(cd))
    v = torch.einsum("bnd,dhk->bnhk", vision_embeds, xp["wv"].to(cd))
    return k, v


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def layer_decode(p: dict, x: Tensor, cfg, plan: BuildPlan, kv_cache,
                 pos: int, ssm_state=None, rwkv_state=None):
    """x: (B, 1, d) at absolute position `pos`. Returns (x, kv_cache,
    state); the KV cache is updated in place, a parallel-SSM layer
    steps its branch from `ssm_state`, an attention-free layer (no KV
    cache) from `rwkv_state`, and returns the new one (None for the
    other families)."""
    check_ported(cfg)
    if cfg.attn_free:
        x, state = _rwkv_layer(p, x, cfg, rwkv_state)
        return x, None, state
    xn = apply_norm(p["ln1"], x, cfg)
    q, k, v = qkv_project(p["attn"], xn)
    B = x.shape[0]
    posb = torch.full((B, 1), int(pos), device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    kv_cache = cache_insert(kv_cache, k, v, pos)
    o = decode_attend(q, kv_cache, _hmap(cfg, x.device), pos=pos,
                      window=cfg.sliding_window)
    a_out = attn_mod.out_project(p["attn"], o)
    new_ssm = None
    if cfg.parallel_ssm_heads:
        s_out, new_ssm = ssm_mod.decode_ssm(p["ssm"], xn, cfg, ssm_state)
        a_out = 0.5 * (a_out + s_out)
    x = x + a_out
    return x + _decode_ffn(p, x, cfg, plan), kv_cache, new_ssm


def _decode_ffn(p: dict, x: Tensor, cfg, plan: BuildPlan) -> Tensor:
    """The feed-forward block of a decode step (all slots routed, the
    inactive ones too, as in the JAX package)."""
    return _ffn_full(p, apply_norm(p["ln2"], x, cfg), cfg, plan)[0]


def layer_decode_paged(p: dict, x: Tensor, cfg, plan: BuildPlan,
                       k_pool: Tensor, v_pool: Tensor, block_tables: Tensor,
                       pos: Tensor, k_scale: Tensor = None,
                       v_scale: Tensor = None):
    """One decode step against this layer's pages of the paged KV pool
    (serve/kv_cache.py), updated in place.

    x: (B, 1, d); k_pool/v_pool: (NB, BS, KV, hd) pages; block_tables:
    (B, MAXB) int32 physical page ids per slot; pos: (B,) int32 absolute
    write position per slot, -1 = inactive (nothing written; its output
    row is garbage the runtime ignores). Positions are per slot: slots sit
    at different sequence lengths. Returns (x, k_pool, v_pool).

    With `plan.kv_bits` set the pools hold integer codes and
    k_scale/v_scale (NB, KV) the per-(page, kv_head) scales: the append
    re-quantizes under a running-max page scale and attention dequantizes
    in the kernel. Returns (x, k_pool, v_pool, k_scale, v_scale) then."""
    check_paged(cfg)
    hmap = _hmap(cfg, x.device)
    xn = apply_norm(p["ln1"], x, cfg)
    q, k, v = qkv_project(p["attn"], xn)
    posb = pos.clamp(min=0)[:, None]                     # (B, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    lengths = (pos + 1).clamp(min=0).to(torch.int32)
    if plan.kv_bits:
        attn_mod.paged_insert_quant(k_pool, v_pool, k_scale, v_scale, k, v,
                                    block_tables, pos, kv_bits=plan.kv_bits)
        o = attn_mod.paged_decode_attend_quant(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
            hmap, window=cfg.sliding_window, kv_bits=plan.kv_bits)
    else:
        paged_insert(k_pool, v_pool, k, v, block_tables, pos)
        o = paged_decode_attend(q, k_pool, v_pool, block_tables, lengths,
                                hmap, window=cfg.sliding_window)
    x = x + attn_mod.out_project(p["attn"], o)
    x = x + _decode_ffn(p, x, cfg, plan)
    if plan.kv_bits:
        return x, k_pool, v_pool, k_scale, v_scale
    return x, k_pool, v_pool
