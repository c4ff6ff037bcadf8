"""Grouped-query attention, dense half (port of `repro.models.attention`).

* One device, so no TP head padding: qwen2 keeps its 28 query heads.
* Full-sequence causal attention goes through `kernels.ops.flash_attention`
  — the Hopper kernel for CUDA tensors, its plain f32 version on the CPU.
  The JAX model used a jnp pair-scan here; the port makes the kernel the
  card's implementation. The non-causal branch stays `_dense_attention`.
* Decode attends over a bf16 (B, S, KV, hd) cache with a position mask.
  Caches are updated in place (one write per step instead of a copy of
  the whole cache).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import dense_init, zeros_init

Tensor = torch.Tensor
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_param_shapes(cfg) -> dict:
    d, hd, kv, h = (cfg.d_model, cfg.resolved_head_dim, cfg.n_kv_heads,
                    cfg.n_heads)
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    if cfg.qkv_bias:
        shapes.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    return shapes


def init_attn(gen: torch.Generator, cfg, device) -> dict:
    out = {}
    for name, shp in sorted(attn_param_shapes(cfg).items()):
        if name.startswith("b"):
            out[name] = zeros_init(shp, device)
        else:
            out[name] = dense_init(gen, shp, device)
    return out


def head_to_kv_map(n_heads: int, n_heads_padded: int, n_kv: int,
                   device=None) -> Tensor:
    """Static q-head -> kv-head index map: h // (Hp/KV) when the padded
    head count divides into kv groups; otherwise floor mapping with padded
    heads parked on kv 0."""
    idx = torch.arange(n_heads_padded, device=device)
    if n_heads_padded % n_kv == 0:
        return idx // (n_heads_padded // n_kv)
    q_per_kv = max(n_heads // n_kv, 1)
    return torch.where(idx < n_heads,
                       torch.clamp(idx // q_per_kv, max=n_kv - 1),
                       torch.zeros_like(idx))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _project_in(w, x: Tensor, cd) -> Tensor:
    """(B, T, d) · w -> (B, T, H, hd); w dense (d, H, hd) or a fused-layout
    QT whose codes are (d, H·hd), routed through quant_matmul."""
    from repro_torch.core.apply import is_qt, qt_linear, qt_out_dims
    if is_qt(w):
        B, T, d = x.shape
        y = qt_linear(w, x.reshape(B * T, d), out_dtype=cd)
        return y.reshape(B, T, *qt_out_dims(w))
    return torch.einsum("btd,dhk->bthk", x, w.to(cd))


def qkv_project(p: dict, x: Tensor):
    """x: (B, T, d) -> q (B,T,Hp,hd), k/v (B,T,KV,hd)."""
    cd = x.dtype
    q = _project_in(p["wq"], x, cd)
    k = _project_in(p["wk"], x, cd)
    v = _project_in(p["wv"], x, cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def out_project(p: dict, o: Tensor) -> Tensor:
    from repro_torch.core.apply import is_qt, qt_linear, qt_out_dims
    w = p["wo"]
    if is_qt(w):
        B, T, H, hd = o.shape
        y = qt_linear(w, o.reshape(B * T, H * hd), out_dtype=o.dtype)
        return y.reshape(B, T, *qt_out_dims(w))
    return torch.einsum("bthk,hkd->btd", o, w.to(o.dtype))


# ---------------------------------------------------------------------------
# full-sequence attention (calibration / eval / prefill)
# ---------------------------------------------------------------------------

def flash_attention(q: Tensor, k: Tensor, v: Tensor, head_map: Tensor, *,
                    causal: bool = True, window: int = 0) -> Tensor:
    """q: (B,T,Hp,hd); k,v: (B,T,KV,hd). Returns (B,T,Hp,hd).

    Causal (and sliding-window) attention runs the `flash_attention`
    kernel dispatch; GQA maps head h to KV head h // (Hp/KV), so an uneven
    head map (hymba) is not supported here."""
    if not causal:
        return _dense_attention(q, k, v, head_map, causal=False, window=0)
    if q.shape[2] % k.shape[2]:
        raise NotImplementedError(
            "flash_attention needs Hp % KV == 0 (the uneven hymba head map "
            "is not ported)")
    from repro_torch.kernels import ops
    return ops.flash_attention(q, k, v, causal=True, window=window)


def _dense_attention(q: Tensor, k: Tensor, v: Tensor, head_map: Tensor, *,
                     causal: bool, window: int,
                     q_positions: Optional[Tensor] = None,
                     kv_positions: Optional[Tensor] = None,
                     kv_valid: Optional[Tensor] = None) -> Tensor:
    """Dense masked attention: non-causal layers and decode over a cache.

    kv_positions/kv_valid: (B, S) absolute positions + validity;
    q_positions: (B, Tq). Grouped GQA einsum when Hp % KV == 0."""
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    grouped = H % KV == 0
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    if grouped:
        G = H // KV
        qg = q.reshape(B, Tq, KV, G, hd)
        s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    else:
        k = k[:, :, head_map, :]
        v = v[:, :, head_map, :]
        s = torch.einsum("bthk,bshk->bhts", q.float(), k.float()) * scale
    mask = torch.ones(B, 1, Tq, S, dtype=torch.bool, device=q.device)
    if causal:
        qp = (q_positions if q_positions is not None
              else torch.arange(Tq, device=q.device).expand(B, Tq))
        kp = (kv_positions if kv_positions is not None
              else torch.arange(S, device=q.device).expand(B, S))
        mask = mask & (qp[:, None, :, None] >= kp[:, None, None, :])
        if window > 0:
            mask = mask & (qp[:, None, :, None] - kp[:, None, None, :]
                           < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    if grouped:
        s = torch.where(mask[:, :, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(),
                           v.float())
        return out.reshape(B, Tq, H, hd).to(q.dtype)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshk->bthk", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (bf16; full caches and SWA ring buffers)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor          # (B, S_cache, KV, hd) — rope pre-applied
    v: Tensor          # (B, S_cache, KV, hd)
    pos: Tensor        # (B, S_cache) absolute positions, -1 = empty


def init_kv_cache(batch: int, cache_len: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros(batch, cache_len, n_kv, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, cache_len, n_kv, hd, dtype=dtype, device=device),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32,
                       device=device),
    )


def cache_insert(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 pos: int) -> KVCache:
    """Write one token (B, 1, KV, hd) at absolute position `pos`, in place.
    Ring semantics: slot = pos % cache_len."""
    slot = int(pos) % cache.k.shape[1]
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[:, slot] = int(pos)
    return cache


def cache_prefill(cache: KVCache, k: Tensor, v: Tensor) -> KVCache:
    """Write a full prefix (B, T, KV, hd) into the cache (ring-aware), in
    place."""
    B, T = k.shape[0], k.shape[1]
    S = cache.k.shape[1]
    if T <= S:
        cache.k[:, :T] = k.to(cache.k.dtype)
        cache.v[:, :T] = v.to(cache.v.dtype)
        cache.pos[:, :T] = torch.arange(T, dtype=torch.int32,
                                        device=k.device)
        return cache
    # ring: keep the last S positions, rotated so that slot = pos % S
    shift = (T - S) % S
    pos = torch.arange(T - S, T, dtype=torch.int32, device=k.device)
    cache.k.copy_(torch.roll(k[:, -S:].to(cache.k.dtype), shift, 1))
    cache.v.copy_(torch.roll(v[:, -S:].to(cache.v.dtype), shift, 1))
    cache.pos.copy_(torch.roll(pos, shift, 0).expand(B, S))
    return cache


def decode_attend(q: Tensor, cache: KVCache, head_map: Tensor, *,
                  pos: int, window: int = 0) -> Tensor:
    """q: (B, 1, Hp, hd) at absolute position `pos`."""
    B = q.shape[0]
    qp = torch.full((B, 1), int(pos), dtype=torch.int32, device=q.device)
    return _dense_attention(q, cache.k, cache.v, head_map, causal=True,
                            window=window, q_positions=qp,
                            kv_positions=cache.pos, kv_valid=cache.pos >= 0)
