"""RWKV6 "Finch" blocks: time-mix with data-dependent decay, and
channel-mix (port of `repro.models.rwkv`).

The wkv recurrence  S_t = diag(w_t) S_{t-1} + k_t v_t^T,
                    o_t = r_t (diag(u) k_t v_t^T + S_{t-1})
runs in chunked matrix form, as in the JAX package: within a chunk of 16
the pairwise decays exp(L_{t-1} - L_s) factor into r·exp(L_{t-1}) and
k·exp(-L) (safe in f32 because the log-decay is clipped to [-5, 0), so a
chunk's exponents stay within e^±80), and a Python loop over the chunks
carries the (B, H, hd, hd) state. A sequence whose length is not a
multiple of 16 (a decode step among them) runs chunks of 1. The wkv runs
in f32 whatever the compute type, and needs full-f32 matmuls (no TF32:
`launch.quantize.set_precision`). Neither package has a kernel for it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, ones_init, zeros_init

Tensor = torch.Tensor

WKV_CHUNK = 16
LOGW_MIN = -5.0


class RWKVState(NamedTuple):
    x_tm: Tensor     # (B, 1, d) last ln1 row, for the time-mix shift
    x_cm: Tensor     # (B, 1, d) last ln2 row, for the channel-mix shift
    s: Tensor        # (B, H, hd, hd) wkv state (k-major, v-minor)


def _dims(cfg):
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    return d, d // hd, hd


def rwkv_param_shapes(cfg) -> dict:
    """{"tm": {leaf: shape}, "cm": {leaf: shape}} of one layer."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv
    lo = r.token_shift_lora
    tm = {"mu_base": (d,), "w1_ts": (d, 5 * lo), "w2_ts": (5, lo, d),
          "mu_rkvwg": (5, d), "w_r": (d, d), "w_k": (d, d), "w_v": (d, d),
          "w_g": (d, d), "w0_decay": (d,), "w1_decay": (d, r.decay_lora),
          "w2_decay": (r.decay_lora, d), "u_bonus": (d,), "ln_w": (d,),
          "w_o": (d, d)}
    cm = {"mu_k": (d,), "mu_r": (d,), "w_k": (d, f), "w_v": (f, d),
          "w_r": (d, d)}
    return {"tm": tm, "cm": cm}


def init_time_mix(gen: torch.Generator, cfg, device) -> dict:
    s = rwkv_param_shapes(cfg)["tm"]
    p = {k: dense_init(gen, s[k], device)
         for k in ("w1_ts", "w2_ts", "w_r", "w_k", "w_v", "w_g",
                   "w1_decay", "w2_decay", "w_o")}
    p.update(mu_base=ones_init(s["mu_base"], device) * 0.5,
             mu_rkvwg=ones_init(s["mu_rkvwg"], device) * 0.5,
             w0_decay=ones_init(s["w0_decay"], device) * -4.0,
             u_bonus=zeros_init(s["u_bonus"], device),
             ln_w=ones_init(s["ln_w"], device))      # per-head group norm
    return p


def init_channel_mix(gen: torch.Generator, cfg, device) -> dict:
    s = rwkv_param_shapes(cfg)["cm"]
    return {"mu_k": ones_init(s["mu_k"], device) * 0.5,
            "mu_r": ones_init(s["mu_r"], device) * 0.5,
            "w_k": dense_init(gen, s["w_k"], device),
            "w_v": dense_init(gen, s["w_v"], device),
            "w_r": dense_init(gen, s["w_r"], device)}


def init_rwkv_state(batch: int, cfg, dtype=torch.float32,
                    device=None) -> RWKVState:
    d, h, hd = _dims(cfg)
    return RWKVState(
        x_tm=torch.zeros(batch, 1, d, dtype=dtype, device=device),
        x_cm=torch.zeros(batch, 1, d, dtype=dtype, device=device),
        s=torch.zeros(batch, h, hd, hd, dtype=dtype, device=device))


def _token_shift(x: Tensor, x_prev: Tensor) -> Tensor:
    """shifted[t] = x[t-1], with x_prev filling slot 0. x: (B, T, d)."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: Tensor, xx: Tensor):
    """Data-dependent lerp -> the five mixed inputs (r, k, v, w, g)."""
    B, T, _ = x.shape
    cd = x.dtype
    base = x + xx * p["mu_base"].to(cd)
    h1 = torch.tanh(torch.einsum("btd,df->btf", base, p["w1_ts"].to(cd)))
    h1 = h1.reshape(B, T, 5, -1)
    lora = torch.einsum("btgf,gfd->btgd", h1, p["w2_ts"].to(cd))
    mix = p["mu_rkvwg"].to(cd)[None, None] + lora           # (B, T, 5, d)
    return [x + xx * mix[:, :, i] for i in range(5)]


def _wkv_chunk(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
               s0: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk. r/k/v/logw: (B, C, H, hd) f32; u: (H, hd); s0:
    (B, H, hd, hd). Returns (out (B, C, H, hd), s_end)."""
    C = r.shape[1]
    L = torch.cumsum(logw, dim=1)                      # inclusive
    Lprev = L - logw                                   # exclusive
    r_t = r * torch.exp(Lprev)
    k_t = k * torch.exp(-L)
    att = torch.einsum("bchk,bshk->bhcs", r_t, k_t)    # (B, H, C, C)
    tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device),
                     diagonal=-1)
    att = att.masked_fill(~tri, 0.0)
    diag = torch.einsum("bchk,bchk->bhc", r, u[None, None] * k)
    out = torch.einsum("bhcs,bshk->bchk", att, v)
    out = out + diag.transpose(1, 2)[..., None] * v
    out = out + torch.einsum("bchk,bhkv->bchv", r_t, s0)
    k_end = k * torch.exp(L[:, -1:] - L)               # decay to chunk end
    s_end = (torch.exp(L[:, -1])[..., None] * s0
             + torch.einsum("bchk,bchv->bhkv", k_end, v))
    return out, s_end


def _wkv_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
              s0: Tensor, *, chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked wkv recurrence. r/k/v/logw: (B, T, H, hd) f32, T a multiple
    of `chunk`. Returns (out (B, T, H·hd), s_end)."""
    B, T, H, hd = r.shape
    outs = []
    s = s0
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        out, s = _wkv_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, s)
        outs.append(out)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, T, H * hd), s


def apply_time_mix(p: dict, x: Tensor, cfg, state: RWKVState, taps=None,
                   quantize_cb=None) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (B, T, d), the ln1 output -> (out, new x_tm, new s). Taps
    tm_r_in / tm_k_in / tm_v_in / tm_g_in (feed w_r / w_k / w_v / w_g)
    and tm_o_in (feeds w_o); `quantize_cb` as in `transformer.layer_full`."""
    d, H, hd = _dims(cfg)
    B, T, _ = x.shape
    cd = x.dtype
    xx = _token_shift(x, state.x_tm) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    if taps is not None:
        taps["tm_r_in"], taps["tm_k_in"] = xr, xk
        taps["tm_v_in"], taps["tm_g_in"] = xv, xg
        if quantize_cb is not None:
            p = {**p, **quantize_cb("tm_r_in"), **quantize_cb("tm_k_in"),
                 **quantize_cb("tm_v_in"), **quantize_cb("tm_g_in")}

    def proj(a, name):
        return torch.einsum("btd,de->bte", a, p[name].to(cd))

    r, k, v = proj(xr, "w_r"), proj(xk, "w_k"), proj(xv, "w_v")
    g = F.silu(proj(xg, "w_g"))
    decay_lora = torch.einsum(
        "btf,fd->btd", torch.tanh(proj(xw, "w1_decay")),
        p["w2_decay"].to(cd))
    logw = -torch.exp(torch.clamp(p["w0_decay"].float()
                                  + decay_lora.float(), -8.0, 1.61))
    logw = torch.clamp(logw, LOGW_MIN, -1e-6)          # log-decay in [-5, 0)

    def heads(a):
        return a.reshape(B, T, H, hd).float()

    r, k, v, logw = heads(r), heads(k), heads(v), heads(logw)
    u = p["u_bonus"].reshape(H, hd).float()
    C = WKV_CHUNK if T % WKV_CHUNK == 0 and T >= WKV_CHUNK else 1
    out, s_fin = _wkv_scan(r, k, v, logw, u, state.s.float(), chunk=C)

    # per-head group norm (biased variance, fixed eps), gate, out-projection
    oh = out.reshape(B, T, H, hd)
    var, mean = torch.var_mean(oh, dim=-1, keepdim=True, correction=0)
    oh = (oh - mean) * torch.rsqrt(var + 1e-5)
    out = oh.reshape(B, T, d) * p["ln_w"].float()
    out = out.to(cd) * g
    if taps is not None:
        taps["tm_o_in"] = out
        if quantize_cb is not None:
            p = {**p, **quantize_cb("tm_o_in")}
    out = proj(out, "w_o")
    return out, x[:, -1:].to(state.x_tm.dtype), s_fin.to(state.s.dtype)


def apply_channel_mix(p: dict, x: Tensor, cfg, x_prev: Tensor, taps=None,
                      quantize_cb=None) -> Tuple[Tensor, Tensor]:
    """x: (B, T, d), the ln2 output -> (out, new x_cm). Taps cm_k_in /
    cm_r_in (feed w_k / w_r) and cm_v_in (feeds w_v)."""
    cd = x.dtype
    xx = _token_shift(x, x_prev) - x
    xk = x + xx * p["mu_k"].to(cd)
    xr = x + xx * p["mu_r"].to(cd)
    if taps is not None:
        taps["cm_k_in"], taps["cm_r_in"] = xk, xr
        if quantize_cb is not None:
            p = {**p, **quantize_cb("cm_k_in"), **quantize_cb("cm_r_in")}
    k = torch.einsum("btd,df->btf", xk, p["w_k"].to(cd))
    ksq = torch.square(F.relu(k))
    if taps is not None:
        taps["cm_v_in"] = ksq
        if quantize_cb is not None:
            p = {**p, **quantize_cb("cm_v_in")}
    v = torch.einsum("btf,fd->btd", ksq, p["w_v"].to(cd))
    r = torch.sigmoid(torch.einsum("btd,de->bte", xr, p["w_r"].to(cd)))
    return r * v, x[:, -1:].to(x_prev.dtype)
