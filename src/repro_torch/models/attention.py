"""Grouped-query attention, dense half (port of `repro.models.attention`).

* One device, so no TP head padding: qwen2 keeps its 28 query heads.
* Full-sequence attention — causal, windowed or non-causal (the encoder,
  and the VLM's cross-attention over the image, Tq != Tk) — goes through
  `kernels.ops.flash_attention`: the Hopper kernel for CUDA tensors, its
  plain f32 version on the CPU. The JAX model uses a jnp pair-scan for
  causal calls and `_dense_attention` for the others; the port makes the
  kernel the card's implementation of both.
* Decode attends over a (B, S, KV, hd) cache with a position mask: bf16,
  or int8 codes with per-entry scales (`BuildPlan.cache_quant`),
  dequantized before the attention. Caches are updated in place (one
  write per step instead of a copy of the whole cache).
* Paged decode (the serving runtime) writes one row per slot into a page
  pool, bf16/f32 or quantized, in place, and attends through
  `kernels.ops.paged_attention[_quant]`.
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
    """q: (B,Tq,Hp,hd); k,v: (B,Tk,KV,hd). Returns (B,Tq,Hp,hd).

    Every call runs the `flash_attention` kernel dispatch: causal (and
    sliding-window) self-attention, or non-causal attention with Tq and
    Tk free (the encoder; the VLM's cross-attention over the image, where
    the JAX package calls `_dense_attention`: the same function). GQA maps
    head h to KV head h // (Hp/KV). On one device every ported config
    divides evenly (hymba: 25 over 5); the uneven map exists only under
    tensor-parallel head padding, which is not ported."""
    if q.shape[2] % k.shape[2]:
        raise NotImplementedError(
            "flash_attention needs Hp % KV == 0 (an uneven head map, as "
            "hymba's under tensor-parallel head padding, is not ported: "
            "ROADMAP.md item 17c)")
    from repro_torch.kernels import ops
    return ops.flash_attention(q, k, v, causal=causal,
                               window=window if causal else 0)


def _dense_attention(q: Tensor, k: Tensor, v: Tensor, head_map: Tensor, *,
                     causal: bool, window: int,
                     q_positions: Optional[Tensor] = None,
                     kv_positions: Optional[Tensor] = None,
                     kv_valid: Optional[Tensor] = None) -> Tensor:
    """Dense masked attention: decode over a (dense) cache.

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
# KV cache (bf16 or int8; full caches and SWA ring buffers)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor          # (B, S_cache, KV, hd) — rope pre-applied
    v: Tensor          # (B, S_cache, KV, hd)
    pos: Tensor        # (B, S_cache) absolute positions, -1 = empty
    # int8 cache (BuildPlan.cache_quant): k/v hold int8 codes and these
    # the per-entry absmax/127 scales, (B, S_cache, KV) f32
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None


def init_kv_cache(batch: int, cache_len: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, device=None,
                  quantized: bool = False) -> KVCache:
    pos = torch.full((batch, cache_len), -1, dtype=torch.int32,
                     device=device)
    if quantized:
        shape = (batch, cache_len, n_kv, hd)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device), pos=pos,
            k_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))
    return KVCache(
        k=torch.zeros(batch, cache_len, n_kv, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, cache_len, n_kv, hd, dtype=dtype, device=device),
        pos=pos)


def _q8_kv(x: Tensor):
    """(..., hd) -> int8 codes and the per-vector f32 scale absmax/127.
    `torch.round` rounds half to even, as `jnp.round` does."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dq8_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def cache_insert(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 pos: int) -> KVCache:
    """Write one token (B, 1, KV, hd) at absolute position `pos`, in place
    (quantized to int8 codes + scales for an int8 cache). Ring semantics:
    slot = pos % cache_len."""
    slot = int(pos) % cache.k.shape[1]
    if cache.k_scale is not None:
        for codes, scales, new in ((cache.k, cache.k_scale, k_new),
                                   (cache.v, cache.v_scale, v_new)):
            q, sc = _q8_kv(new[:, 0])
            codes[:, slot] = q
            scales[:, slot] = sc
    else:
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[:, slot] = int(pos)
    return cache


def cache_prefill(cache: KVCache, k: Tensor, v: Tensor) -> KVCache:
    """Write a full prefix (B, T, KV, hd) into the cache (ring-aware), in
    place; an int8 cache takes codes and per-entry scales."""
    B, T = k.shape[0], k.shape[1]
    S = cache.k.shape[1]
    if cache.k_scale is not None:
        (kq, ks), (vq, vs) = _q8_kv(k), _q8_kv(v)
        pairs = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                 (cache.v_scale, vs))
    else:
        pairs = ((cache.k, k.to(cache.k.dtype)),
                 (cache.v, v.to(cache.v.dtype)))
    if T <= S:
        for dst, src in pairs:
            dst[:, :T] = src
        cache.pos[:, :T] = torch.arange(T, dtype=torch.int32,
                                        device=k.device)
        return cache
    # ring: keep the last S positions, rotated so that slot = pos % S
    shift = (T - S) % S
    pos = torch.arange(T - S, T, dtype=torch.int32, device=k.device)
    for dst, src in pairs:
        dst.copy_(torch.roll(src[:, -S:], shift, 1))
    cache.pos.copy_(torch.roll(pos, shift, 0).expand(B, S))
    return cache


def decode_attend(q: Tensor, cache: KVCache, head_map: Tensor, *,
                  pos: int, window: int = 0) -> Tensor:
    """q: (B, 1, Hp, hd) at absolute position `pos`. An int8 cache is
    dequantized to q's dtype first."""
    B = q.shape[0]
    qp = torch.full((B, 1), int(pos), dtype=torch.int32, device=q.device)
    k, v = cache.k, cache.v
    if cache.k_scale is not None:
        k = _dq8_kv(k, cache.k_scale, q.dtype)
        v = _dq8_kv(v, cache.v_scale, q.dtype)
    return _dense_attention(q, k, v, head_map, causal=True,
                            window=window, q_positions=qp,
                            kv_positions=cache.pos, kv_valid=cache.pos >= 0)


# ---------------------------------------------------------------------------
# paged KV cache (serve/kv_cache.py owns the pool + block tables; these are
# the per-layer device ops of a continuous-batching decode step). Pools are
# updated in place.
# ---------------------------------------------------------------------------

def _slot_rows(block_tables: Tensor, pos: Tensor, BS: int):
    """(physical page, offset, active) of each slot's write position;
    inactive slots (pos -1) read position 0 of their table row."""
    safe = pos.clamp(min=0).long()
    phys = torch.gather(block_tables.long(), 1, (safe // BS)[:, None])[:, 0]
    return phys, safe % BS, pos >= 0


def _redirect_inactive(active: Tensor, *vals: Tensor):
    """Point every inactive slot's write at the first active slot's, with
    the same value. Slots own disjoint pages, so active writes never
    collide, and an inactive slot's write becomes an exact duplicate of an
    active one: a scatter that drops inactive slots without reading `pos`
    on the host. With no active slot, every slot rewrites slot 0's values,
    which the callers set to what the pool already holds there."""
    first = torch.argmax(active.to(torch.int32))
    return [torch.where(active.view(-1, *[1] * (v.dim() - 1)), v, v[first])
            for v in vals]


def paged_insert(k_pool: Tensor, v_pool: Tensor, k_new: Tensor,
                 v_new: Tensor, block_tables: Tensor, pos: Tensor):
    """Write one token per slot into the paged pool, in place.

    k_pool/v_pool: (NB, BS, KV, hd); k_new/v_new: (B, 1, KV, hd);
    block_tables: (B, MAXB) physical block ids; pos: (B,) absolute write
    position, -1 = inactive slot (nothing written)."""
    NB, BS = k_pool.shape[0], k_pool.shape[1]
    phys, off, active = _slot_rows(block_tables, pos, BS)
    dest = phys * BS + off
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = pool.view(NB * BS, *pool.shape[2:])
        val = torch.where(active[:, None, None], new[:, 0].to(pool.dtype),
                          flat[dest])
        d, val = _redirect_inactive(active, dest, val)
        flat[d] = val
    return k_pool, v_pool


def paged_gather(pool: Tensor, block_tables: Tensor) -> Tensor:
    """(NB, BS, KV, hd) + (B, MAXB) -> (B, MAXB·BS, KV, hd): a slot's pages
    in logical order (row i holds position i)."""
    NB, BS = pool.shape[0], pool.shape[1]
    B, MAXB = block_tables.shape
    idx = (block_tables.long()[:, :, None] * BS
           + torch.arange(BS, device=pool.device)[None, None])
    return pool.reshape(NB * BS, *pool.shape[2:])[idx.reshape(B, MAXB * BS)]


def _grouped_heads(q: Tensor, k_pool: Tensor) -> None:
    if q.shape[2] % k_pool.shape[2]:
        raise NotImplementedError(
            "paged decode attention needs Hp % KV == 0 (an uneven head map, "
            "as hymba's under tensor-parallel head padding, is not ported: "
            "ROADMAP.md item 17c)")


def paged_decode_attend(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                        block_tables: Tensor, lengths: Tensor,
                        head_map: Tensor, *, window: int = 0) -> Tensor:
    """q: (B, 1, Hp, hd); lengths: (B,) int32 valid tokens per slot (0
    inactive). Runs `ops.paged_attention`: the kernel for CUDA tensors,
    its plain version on the CPU. Returns (B, 1, Hp, hd) in q.dtype."""
    _grouped_heads(q, k_pool)
    from repro_torch.kernels import ops
    o = ops.paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                            block_tables, lengths, window=window)
    return o[:, None]


def paged_insert_quant(k_pool: Tensor, v_pool: Tensor, k_scale: Tensor,
                       v_scale: Tensor, k_new: Tensor, v_new: Tensor,
                       block_tables: Tensor, pos: Tensor, *, kv_bits: int):
    """Write one token per slot into a quantized pool (decode append), in
    place.

    k_pool/v_pool: (NB, BS, KV, hd/cpb) integer codes; k_scale/v_scale:
    (NB, KV) f32 per-(page, kv_head) scales; k_new/v_new: (B, 1, KV, hd)
    float; pos: (B,), -1 = inactive (nothing written).

    The page scale is a running max: appending a token with a larger
    absmax raises the page scale, and the page's existing codes rescale
    by old/new (exact when the scale is unchanged, at most one code unit
    of double rounding when it grows). A token at page offset 0 starts a
    fresh page: the old scale and codes belong to a freed request and are
    overwritten, not maxed. Returns (k_pool, k_scale, v_pool, v_scale)."""
    from repro_torch.core.quantizer import pack_int4, unpack_int4
    from repro_torch.serve.kv_cache import _kv_qmax, kv_encode, kv_scale_of
    BS = k_pool.shape[1]
    qmax = _kv_qmax(kv_bits)
    phys, off, active = _slot_rows(block_tables, pos, BS)
    fresh = (off == 0)[:, None]                      # (B, 1)
    at_off = (torch.arange(BS, device=pos.device)[None, :, None, None]
              == off[:, None, None, None])
    for pool, scale, new in ((k_pool, k_scale, k_new),
                             (v_pool, v_scale, v_new)):
        row = new[:, 0].float()                      # (B, KV, hd)
        s_tok = kv_scale_of(row.abs().amax(dim=-1), kv_bits)
        old = scale[phys]                            # (B, KV)
        s_new = torch.where(fresh, s_tok, torch.maximum(old, s_tok))
        # rescale the page's existing codes to the (possibly) raised
        # scale; ratio 0 wipes a fresh page's stale codes outright
        ratio = torch.where(fresh | (s_new <= 0), 0.0,
                            old / torch.where(s_new > 0, s_new, 1.0))
        page = pool[phys]                            # (B, BS, KV, hd/cpb)
        if kv_bits == 8:
            pq = page.float() * ratio[:, None, :, None]
            page2 = torch.clamp(torch.round(pq), -qmax, qmax).to(torch.int8)
        else:
            pq = (unpack_int4(page).float() - 8.0) * ratio[:, None, :, None]
            pq = torch.clamp(torch.round(pq), -qmax, qmax)
            page2 = pack_int4((pq + 8.0).to(torch.uint8))
        tok = kv_encode(row, s_new, kv_bits)         # (B, KV, hd/cpb)
        page2 = torch.where(at_off, tok[:, None], page2)
        page2 = torch.where(active[:, None, None, None], page2, page)
        s_new = torch.where(active[:, None], s_new, old)
        d, page2, s_new = _redirect_inactive(active, phys, page2, s_new)
        pool[d] = page2
        scale[d] = s_new
    return k_pool, k_scale, v_pool, v_scale


def paged_decode_attend_quant(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                              k_scale: Tensor, v_scale: Tensor,
                              block_tables: Tensor, lengths: Tensor,
                              head_map: Tensor, *, window: int = 0,
                              kv_bits: int = 8) -> Tensor:
    """Quantized-pool decode attention through
    `ops.paged_attention_quant`: the kernel streams codes and folds the
    per-page scales in; the plain version dequantizes in f32."""
    _grouped_heads(q, k_pool)
    from repro_torch.kernels import ops
    o = ops.paged_attention_quant(q[:, 0].contiguous(), k_pool, v_pool,
                                  k_scale, v_scale, block_tables, lengths,
                                  window=window, kv_bits=kv_bits)
    return o[:, None]
