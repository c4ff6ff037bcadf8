"""Top-level model API: the dense (and audio), MoE, hybrid, RWKV, VLM
and encoder families (port of `repro.models.model`).

    params = init_params(cfg, seed=0, device=None)
    logits, aux, cache = forward(params, cfg, plan, tokens, make_cache=...)
    loss, metrics = lm_loss(params, cfg, plan, batch)
    logits, cache = prefill(params, cfg, plan, tokens)
    logits, cache = decode_step(params, cfg, plan, cache, tokens, pos)
    logits, pool = decode_step_paged(params, cfg, plan, pool, block_tables,
                                     tokens, pos)

`params["layers"]` is a per-layer list of dicts with the JAX leaf names
and per-layer shapes (wq (d, H, hd), wo (H, hd, d), w_down (f, d), ...).
Layer leaves may be QT (packed codes, core/apply.py): `forward`
dequantizes them per layer, `decode_step` keeps the fused projections
packed and runs them through quant_matmul; `decode_step_paged` does the
same against a paged KV pool with one position per slot (serve/).
A hybrid model (hymba) carries one SSM state per layer: `forward` starts
every layer from zeros, the cache holds the states under "ssm", and
`decode_step` threads them; the paged pool does not serve it. An RWKV
model (attention-free) does the same with one RWKVState a layer under
"rwkv" and has no KV cache.
A VLM (llama-3.2-vision) holds `params["groups"]`: "self", a per-group
list of per-layer lists, and "cross", a per-group list of gated
cross-attention layers, plus `vision_proj`; `forward`, `prefill` and
`lm_loss` take the image's patch embeddings (`vision_embeds`, (B, N,
vision_dim)), and the cache adds the image's K/V a group under "xkv".
An encoder (ViT) runs from patch embeddings (`embeds`) plus `pos_embed`,
non-causal, and mean-pools into `cls_head` (no embed / unembed).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.common import (apply_norm, dense_init, dtype_of,
                                       embed_init, norm_params)
from repro_torch.models.transformer import BuildPlan

Tensor = torch.Tensor
Params = Dict[str, Any]
POS_EMBED_ROWS = 4096    # an encoder's learned positions (JAX's init)


def vlm_group_counts(cfg):
    """(n_groups, self layers a group) of a VLM: every `every`-th layer is
    a cross layer."""
    every = cfg.cross_attn.every
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} does not "
                         f"divide into groups of {every}")
    return cfg.n_layers // every, every - 1


def init_params(cfg, *, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from `torch.Generator(device).manual_seed(seed)`."""
    tfm.check_ported(cfg)
    plan = BuildPlan()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    p: Params = {}
    if cfg.family == "encoder":
        p["pos_embed"] = embed_init(gen, (POS_EMBED_ROWS, d), dev)
        p["cls_head"] = dense_init(gen, (d, v), dev)
    else:
        p["embed"] = embed_init(gen, (v, d), dev)
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, (d, v), dev)
    if cfg.family == "vlm":
        g, spg = vlm_group_counts(cfg)
        p["vision_proj"] = dense_init(gen, (cfg.cross_attn.vision_dim, d),
                                      dev)
        p["groups"] = {
            "self": [[tfm.init_layer(gen, cfg, plan, dev)
                      for _ in range(spg)] for _ in range(g)],
            "cross": [tfm.init_cross_layer(gen, cfg, dev)
                      for _ in range(g)]}
    else:
        p["layers"] = [tfm.init_layer(gen, cfg, plan, dev)
                       for _ in range(cfg.n_layers)]
    p["final_norm"] = norm_params(cfg, dev)
    return p


def param_count(cfg, active_only: bool = False) -> int:
    """Parameters of the model (embeddings, layers, final norm); with
    `active_only`, an MoE model counts top_k of its experts a layer (the
    JAX package's `count_params_analytic`)."""
    from repro_torch.models.attention import attn_param_shapes
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    norm = 2 * d if cfg.norm_type == "layernorm" else d   # scale (+ bias)
    if cfg.family == "encoder":     # pos_embed and cls_head
        embeds = POS_EMBED_ROWS * d + d * v
    else:
        embeds = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.attn_free:
        per_layer = 2 * norm + sum(
            math.prod(s) for mod in rwkv_mod.rwkv_param_shapes(cfg).values()
            for s in mod.values())
        return embeds + cfg.n_layers * per_layer + norm
    per_layer = sum(math.prod(s) for s in attn_param_shapes(cfg).values())
    per_layer += 2 * norm
    if cfg.parallel_ssm_heads:
        per_layer += sum(math.prod(s) for s in
                         ssm_mod.ssm_param_shapes(cfg).values())
    n_ff_mats = 2 if cfg.act == "gelu_mlp" else 3
    if cfg.moe is not None:
        e = cfg.moe.n_experts
        per_layer += d * e + 3 * e * d * f      # router, w_gate/w_up/w_down
        if active_only:
            per_layer -= (e - cfg.moe.top_k) * n_ff_mats * d * f
    else:
        per_layer += n_ff_mats * d * f
    if cfg.family == "vlm":     # a cross layer is a self layer + 2 gates
        g, _ = vlm_group_counts(cfg)
        embeds += cfg.cross_attn.vision_dim * d + 2 * g
    return embeds + cfg.n_layers * per_layer + norm


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(p: Params, cfg, plan: BuildPlan, tokens: Tensor) -> Tensor:
    from repro_torch.core.apply import is_qt
    from repro_torch.core.quantizer import unpack_codes
    cd = dtype_of(cfg.compute_dtype)
    emb = p["embed"]
    if is_qt(emb):
        # gather code rows first, dequantize only the touched rows
        rows = unpack_codes(emb.codes[tokens], emb.cpb)
        return ((rows.float() + emb.z_lo.float()) * emb.scale).to(cd)
    return emb[tokens].to(cd)


def unembed(p: Params, cfg, plan: BuildPlan, x: Tensor) -> Tensor:
    from repro_torch.core.apply import is_qt
    cd = x.dtype
    w = p["unembed"] if not cfg.tie_embeddings else p["embed"].T
    if is_qt(w):
        w = w.dequant(cd)
    return torch.einsum("btd,dv->btv", x, w.to(cd))


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _remat(plan, body):
    """`body` recomputed in the backward pass (`torch.utils.checkpoint`,
    non-reentrant) when the plan asks for it and autograd is recording, as
    the JAX package wraps its layer bodies in `jax.checkpoint`; `body`
    itself otherwise, so no_grad paths pay nothing."""
    if not (plan.remat and torch.is_grad_enabled()):
        return body
    from torch.utils.checkpoint import checkpoint
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def _run_layers(p: Params, cfg, plan, x, make_cache: bool):
    """Returns (x, caches, aux, states): aux sums the layers' MoE
    load-balance losses (0 for a dense model); a hybrid or RWKV model runs
    every layer from the zero state (the JAX `_run_homogeneous`) and
    `states` holds each layer's final one (None for the other
    families). QT leaves are dequantized a layer at a time, inside the
    (rematerialized) layer body."""
    from repro_torch.core.apply import dequantize_qt_tree
    cd = dtype_of(cfg.compute_dtype)

    def body(lp, x):
        return tfm.layer_full(dequantize_qt_tree(lp, cd), x, cfg, plan,
                              make_cache)

    body = _remat(plan, body)
    caches, states = [], []
    aux = torch.zeros((), device=x.device)
    for lp in p["layers"]:
        x, cache, a, st = body(lp, x)
        caches.append(cache)
        states.append(st)
        if a is not None:
            aux = aux + a
    return x, caches, aux, (states if _state_key(cfg) else None)


def _state_key(cfg):
    """The cache key of a family's per-layer recurrent states, or None."""
    if cfg.attn_free:
        return "rwkv"
    return "ssm" if cfg.parallel_ssm_heads else None


def _run_vlm(p: Params, cfg, plan, x, make_cache: bool, vision_embeds):
    """The VLM's groups: each group's self layers, then its cross layer
    over the projected image. Returns (x, per-group lists of self-layer
    caches, the per-group image K/V stacked as two (G, B, N, KV, hd)
    tensors or None)."""
    from repro_torch.core.apply import dequantize_qt_tree
    cd = dtype_of(cfg.compute_dtype)
    ve = torch.einsum("bnv,vd->bnd", vision_embeds.to(x.dtype),
                      p["vision_proj"].to(x.dtype))

    def self_body(lp, x):
        return tfm.layer_full(dequantize_qt_tree(lp, cd), x, cfg, plan,
                              make_cache)[:2]

    def cross_body(gp_cross, x, ve):
        gp_cross = dequantize_qt_tree(gp_cross, cd)
        k, v = tfm.vision_kv_for_layer(gp_cross, ve)
        return tfm.cross_layer_full(gp_cross, x, cfg, plan, (k, v)), k, v

    self_body, cross_body = _remat(plan, self_body), _remat(plan, cross_body)
    caches, ks, vs = [], [], []
    for gp_self, gp_cross in zip(p["groups"]["self"], p["groups"]["cross"]):
        group = []
        for lp in gp_self:
            x, cache = self_body(lp, x)
            group.append(cache)
        caches.append(group)
        x, k, v = cross_body(gp_cross, x, ve)
        ks.append(k)
        vs.append(v)
    xkv = (torch.stack(ks), torch.stack(vs)) if make_cache else None
    return x, caches, xkv


def _forward_encoder(p: Params, cfg, plan, embeds: Tensor):
    """Patch embeddings (B, T, d) + pos_embed[:T], the non-causal layers,
    final norm, a mean over the tokens, cls_head: f32 logits (B, C)."""
    cd = dtype_of(cfg.compute_dtype)
    x = embeds.to(cd)
    x = x + p["pos_embed"][:x.shape[1]].to(cd)
    x, _, aux, _ = _run_layers(p, cfg, plan, x, False)
    x = apply_norm(p["final_norm"], x, cfg)
    pooled = x.mean(dim=1)
    logits = torch.einsum("bd,dc->bc", pooled, p["cls_head"].to(cd))
    return logits.float(), aux


def forward(p: Params, cfg, plan: BuildPlan, tokens: Tensor,
            vision_embeds: Tensor = None, embeds: Tensor = None,
            make_cache: bool = False):
    """Returns (logits, aux, cache_or_None): the cache is {"kv": [...]}
    and, for a hybrid model, "ssm": [...] (one state a layer); an RWKV
    model's is {"rwkv": [...]} alone; a VLM's is {"kv": per-group lists,
    "xkv": (k, v)}. A VLM needs `vision_embeds`; an encoder takes
    `embeds` (patch embeddings, no tokens) and returns f32 class logits
    (B, C) and no cache."""
    if cfg.family == "encoder":
        logits, aux = _forward_encoder(p, cfg, plan, embeds)
        return logits, aux, None
    x = embed_tokens(p, cfg, plan, tokens)
    if cfg.family == "vlm":
        x, caches, xkv = _run_vlm(p, cfg, plan, x, make_cache, vision_embeds)
        aux, states = torch.zeros((), device=x.device), None
    else:
        x, caches, aux, states = _run_layers(p, cfg, plan, x, make_cache)
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, plan, x)
    cache = None
    if make_cache:
        cache = {} if cfg.attn_free else {"kv": caches}
        if states is not None:
            cache[_state_key(cfg)] = states
        if cfg.family == "vlm":
            cache["xkv"] = xkv
    return logits, aux, cache


def lm_loss(p: Params, cfg, plan: BuildPlan, batch: Dict[str, Tensor],
            z_loss: float = 1e-4, aux_weight: float = 1e-2):
    """Next-token cross entropy with z-loss (an LM; a VLM reads
    batch["vision_embeds"]), or an encoder's class cross entropy from
    batch["embeds"] and batch["labels"] (B,)."""
    if cfg.family == "encoder":
        logits, aux, _ = forward(p, cfg, plan, None, embeds=batch["embeds"])
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["labels"][:, None].long())[:, 0]
        loss = torch.mean(lse - ll)
        return loss, {"loss": loss, "aux": aux}
    logits, aux, _ = forward(p, cfg, plan, batch["tokens"],
                             vision_embeds=batch.get("vision_embeds"))
    labels = batch["labels"]
    logits = logits.float()
    # the row max is a constant of the gradient (JAX's stop_gradient): the
    # value is the same, and ties then get JAX's gradient
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    zl = z_loss * torch.mean(torch.square(lse))
    total = loss + zl + aux_weight * aux
    return total, {"loss": loss, "z_loss": zl, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, plan: BuildPlan, batch: int, seq_len: int,
               device: DeviceLike = None):
    """An empty per-layer cache list for decode at context length
    seq_len (int8 codes and scales with `plan.cache_quant`); a hybrid
    model's cache adds one zero SSM state a layer under "ssm"; an RWKV
    model's holds only one zero RWKVState a layer under "rwkv"; a VLM's
    "kv" is a per-group list of per-self-layer caches, and "xkv" the
    image's K/V, two zero (G, B, N, KV, hd) tensors."""
    dev = resolve_device(device)
    if cfg.attn_free:
        return {"rwkv": [rwkv_mod.init_rwkv_state(batch, cfg, device=dev)
                         for _ in range(cfg.n_layers)]}
    clen = cache_len_for(cfg, seq_len)
    hd = cfg.resolved_head_dim

    def kv():
        return init_kv_cache(batch, clen, cfg.n_kv_heads, hd,
                             plan.cache_dtype, dev,
                             quantized=plan.cache_quant)
    if cfg.family == "vlm":
        g, spg = vlm_group_counts(cfg)
        shape = (g, batch, cfg.cross_attn.n_vision_tokens, cfg.n_kv_heads, hd)
        return {"kv": [[kv() for _ in range(spg)] for _ in range(g)],
                "xkv": tuple(torch.zeros(shape, dtype=plan.cache_dtype,
                                         device=dev) for _ in range(2))}
    cache = {"kv": [kv() for _ in range(cfg.n_layers)]}
    if cfg.parallel_ssm_heads:
        cache["ssm"] = [ssm_mod.init_ssm_state(batch, cfg, device=dev)
                        for _ in range(cfg.n_layers)]
    return cache


def prefill(p: Params, cfg, plan: BuildPlan, tokens: Tensor,
            vision_embeds: Tensor = None):
    logits, _, cache = forward(p, cfg, plan, tokens,
                               vision_embeds=vision_embeds, make_cache=True)
    return logits[:, -1], cache


def _decode_vlm(p: Params, cfg, plan, cache, x, pos: int):
    """A VLM decode step: every self and cross layer dequantized (no
    fused leaves, as in the JAX package), the cross layers over the
    cached image K/V. Returns (x, the new cache)."""
    from repro_torch.core.apply import dequantize_qt_tree
    cd = dtype_of(cfg.compute_dtype)
    xk, xv = cache["xkv"]
    new_kv = []
    for g, (gp_self, gp_cross) in enumerate(zip(p["groups"]["self"],
                                                p["groups"]["cross"])):
        group = []
        for lp, kv in zip(gp_self, cache["kv"][g]):
            x, kv, _ = tfm.layer_decode(dequantize_qt_tree(lp, cd), x, cfg,
                                        plan, kv, pos)
            group.append(kv)
        new_kv.append(group)
        x = tfm.cross_layer_full(dequantize_qt_tree(gp_cross, cd), x, cfg,
                                 plan, (xk[g], xv[g]))
    return x, {"kv": new_kv, "xkv": cache["xkv"]}


def decode_step(p: Params, cfg, plan: BuildPlan, cache, tokens: Tensor,
                pos: int):
    """tokens: (B, 1); pos: absolute position (int). Fused-layout QT
    projections stay packed and run through quant_matmul (keep_fused);
    other QT leaves (hymba's w_in / w_out, every RWKV projection) are
    dequantized each step, as in the JAX package. The KV cache is updated
    in place; a hybrid or RWKV model's states are threaded through the
    layers; a VLM dequantizes every layer each step and attends its cross
    layers to the cached image K/V. Returns (logits, the new cache)."""
    from repro_torch.core.apply import dequantize_qt_tree
    cd = dtype_of(cfg.compute_dtype)
    x = embed_tokens(p, cfg, plan, tokens)
    if cfg.family == "vlm":
        x, new_cache = _decode_vlm(p, cfg, plan, cache, x, pos)
        x = apply_norm(p["final_norm"], x, cfg)
        return unembed(p, cfg, plan, x)[:, 0], new_cache
    n = len(p["layers"])
    key = _state_key(cfg)
    states = (cache.get(key) if key else None) or [None] * n
    kvs = cache.get("kv") or [None] * n
    new_kv, new_states = [], []
    for lp, kv, st in zip(p["layers"], kvs, states):
        lp = dequantize_qt_tree(lp, cd, keep_fused=True)
        kw = {f"{key}_state": st} if key else {}
        x, kv, st = tfm.layer_decode(lp, x, cfg, plan, kv, pos, **kw)
        new_kv.append(kv)
        new_states.append(st)
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, plan, x)
    new_cache = {} if cfg.attn_free else {"kv": new_kv}
    if key:
        new_cache[key] = new_states
    return logits[:, 0], new_cache


def decode_step_paged(p: Params, cfg, plan: BuildPlan, pool, block_tables,
                      tokens: Tensor, pos: Tensor):
    """One continuous-batching decode step against a paged KV pool.

    tokens: (B, 1); pos: (B,) int32 absolute write positions per slot (-1 =
    inactive slot: nothing written, its logits are garbage the runtime
    ignores); pool: {"k", "v"[, "k_scale", "v_scale"]} with a leading
    layer dim (serve/kv_cache.py), updated in place; block_tables:
    (B, MAXB) int32 physical page ids. Every slot carries its own
    position, so a mixed-length, staggered-arrival batch decodes in one
    step. Layers run in a Python loop; fused-layout QT projections stay
    packed and run through quant_matmul (keep_fused). Returns
    (logits (B, V), pool)."""
    from repro_torch.core.apply import dequantize_qt_tree
    tfm.check_paged(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embed_tokens(p, cfg, plan, tokens)
    for i, lp in enumerate(p["layers"]):
        lp = dequantize_qt_tree(lp, cd, keep_fused=True)
        scales = ((pool["k_scale"][i], pool["v_scale"][i]) if plan.kv_bits
                  else ())
        x = tfm.layer_decode_paged(lp, x, cfg, plan, pool["k"][i],
                                   pool["v"][i], block_tables, pos,
                                   *scales)[0]
    x = apply_norm(p["final_norm"], x, cfg)
    logits = unembed(p, cfg, plan, x)
    return logits[:, 0], pool
