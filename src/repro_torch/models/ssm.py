"""Mamba-style selective SSM head, hymba's parallel-SSM branch (port of
`repro.models.ssm`).

Calibration, eval and prefill run a *chunked* linear recurrence: a loop
over token chunks carries the (B, d_inner, N) hidden state, and within a
chunk the diagonal recurrence h_t = a_t·h_{t-1} + b_t is solved with a
doubling (Hillis–Steele) scan, log2(C) whole-tensor multiply-adds over the
chunk (the JAX package uses `lax.associative_scan`; neither has a kernel
here). The chunk is JAX's: C = min(chunk, T), halved until it divides T,
so the state handed from chunk to chunk is the same. Decode is the
one-step recurrence. The recurrence runs in f32 whatever the compute
dtype.

The terms are (B, C, d_inner, N) f32 — 210 MB each at hymba's full width
for an 8×128 batch — so a chunk keeps at most three of them alive.

Under `torch.no_grad` (calibration, eval, serve) the scan works in place
of its terms. When autograd records, the chunk runs through `ChunkScan`:
the same doubling scan on its own copies in the forward (the same bits),
and in the backward the reverse-time scan of the adjoint,
λ_t = g_t + a_{t+1}·λ_{t+1}, from which dL/db_t = λ_t, dL/da_t =
λ_t·h_{t-1} (h_{-1} = h0) and dL/dh0 = a_0·λ_0. It saves a_t (which the
exp saves anyway), h0 and the states h; its forward holds a fourth term,
its copy of a.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, ones_init, zeros_init

Tensor = torch.Tensor


class SSMState(NamedTuple):
    h: Tensor        # (B, d_inner, N) f32
    conv: Tensor     # (B, conv_w-1, d_inner) trailing inputs of the conv


def _dims(cfg):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    dt_rank = cfg.ssm.dt_rank or max(1, math.ceil(d / 16))
    return d, di, cfg.ssm.state_dim, dt_rank, cfg.ssm.conv_width


def ssm_param_shapes(cfg) -> dict:
    d, di, n, dt_rank, cw = _dims(cfg)
    return {"w_in": (d, 2 * di), "conv_w": (cw, di), "conv_b": (di,),
            "w_xproj": (di, dt_rank + 2 * n), "w_dt": (dt_rank, di),
            "b_dt": (di,), "a_log": (di, n), "d_skip": (di,),
            "w_out": (di, d)}


def init_ssm(gen: torch.Generator, cfg, device) -> dict:
    d, di, n, dt_rank, cw = _dims(cfg)
    shapes = ssm_param_shapes(cfg)
    a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "w_in": dense_init(gen, shapes["w_in"], device),
        "conv_w": dense_init(gen, shapes["conv_w"], device,
                             scale=1.0 / math.sqrt(cw)),
        "conv_b": zeros_init(shapes["conv_b"], device),
        "w_xproj": dense_init(gen, shapes["w_xproj"], device),
        "w_dt": dense_init(gen, shapes["w_dt"], device),
        "b_dt": ones_init(shapes["b_dt"], device) * -4.6,  # softplus^-1(0.01)
        "a_log": a.expand(di, n).contiguous(),
        "d_skip": ones_init(shapes["d_skip"], device),
        "w_out": dense_init(gen, shapes["w_out"], device),
    }


def init_ssm_state(batch: int, cfg, dtype=torch.float32,
                   device=None) -> SSMState:
    _, di, n, _, cw = _dims(cfg)
    return SSMState(h=torch.zeros(batch, di, n, dtype=dtype, device=device),
                    conv=torch.zeros(batch, cw - 1, di, dtype=dtype,
                                     device=device))


def _causal_conv(p: dict, xi: Tensor, conv_state: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv over T by static shifts. xi: (B, T, di)."""
    cw = p["conv_w"].shape[0]
    ext = torch.cat([conv_state.to(xi.dtype), xi], dim=1)
    T = xi.shape[1]
    out = torch.zeros_like(xi)
    for w in range(cw):
        out = out + ext[:, w:w + T] * p["conv_w"][w].to(xi.dtype)
    out = out + p["conv_b"].to(xi.dtype)
    return out, ext[:, -(cw - 1):].to(conv_state.dtype)


def _selective_terms(p: dict, xi: Tensor, cfg):
    """xi: (B, T, di) after the conv. Returns a_t, b_t (B, T, di, N) and
    c (B, T, N), all f32."""
    _, _, n, dt_rank, _ = _dims(cfg)
    xdbc = torch.einsum("btd,dr->btr", xi, p["w_xproj"].to(xi.dtype))
    dt_raw, b_in, c_in = torch.split(xdbc, [dt_rank, n, n], dim=-1)
    dt = F.softplus(
        torch.einsum("btr,rd->btd", dt_raw, p["w_dt"].to(xi.dtype)).float()
        + p["b_dt"].float())                                     # (B,T,di)
    a = -torch.exp(p["a_log"].float())                           # (di, N)
    a_t = dt[..., None] * a                                      # (B,T,di,N)
    # in place only where autograd does not save the exp's output
    a_t = a_t.exp() if torch.is_grad_enabled() else a_t.exp_()
    bx = (dt * xi.float())[..., None] * b_in.float()[:, :, None, :]
    return a_t, bx, c_in.float()


def _scan_chunk(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """Solve h_t = a_t·h_{t-1} + b_t over axis 1 from h0, in place of a
    and b (Hillis–Steele: after the step of stride s, (a_t, b_t) compose
    the 2s terms ending at t). Returns h (B, C, di, N), which is b."""
    C = a.shape[1]
    s = 1
    while s < C:
        # read the left operands into a temporary before writing the
        # overlapping right slice in place
        b[:, s:] += a[:, s:] * b[:, :-s]
        a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return b.addcmul_(a, h0[:, None])


def _scan_chunk_reverse(c: Tensor, g: Tensor) -> Tensor:
    """Solve λ_t = g_t + c_t·λ_{t+1} (λ_C = 0) over axis 1, in place of c
    and g (the doubling scan run backwards in time). Returns λ, which is
    g."""
    C = c.shape[1]
    s = 1
    while s < C:
        g[:, :-s] += c[:, :-s] * g[:, s:]
        c[:, :-s] = c[:, :-s] * c[:, s:]
        s *= 2
    return g


class ChunkScan(torch.autograd.Function):
    """h_t = a_t·h_{t-1} + b_t over one chunk from h0, differentiable
    (module docstring): (B, C, di, N) a and b, (B, di, N) h0, all f32."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan_chunk(a.clone(), b.clone(), h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        c = torch.empty_like(a)               # c_t = a_{t+1}, c_{C-1} = 0
        c[:, :-1] = a[:, 1:]
        c[:, -1] = 0.0
        lam = g.clone(memory_format=torch.contiguous_format)
        lam = _scan_chunk_reverse(c, lam)
        da = c                                # λ_t·h_{t-1}, into c's buffer
        torch.mul(lam[:, 1:], h[:, :-1], out=da[:, 1:])
        torch.mul(lam[:, 0], h0, out=da[:, 0])
        dh0 = a[:, 0] * lam[:, 0]
        return da, lam, dh0


def _scan(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """The chunk's states: `ChunkScan` when autograd records through any
    operand, else the in-place `_scan_chunk`."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return ChunkScan.apply(a, b, h0)
    return _scan_chunk(a, b, h0)


def _ssm_recurrence(sel: dict, xi: Tensor, h0: Tensor, *, cfg,
                    chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked selective recurrence. xi: (B, T, di) after conv and silu;
    h0 (B, di, N) f32. Returns (y (B, T, di) f32, h at the end)."""
    B, T, di = xi.shape
    ys = []
    h = h0
    for c0 in range(0, T, chunk):
        a_t, b_t, c_in = _selective_terms(sel, xi[:, c0:c0 + chunk], cfg)
        hs = _scan(a_t, b_t, h)
        del a_t
        ys.append(torch.einsum("btdn,btn->btd", hs, c_in))
        h = hs[:, -1].clone()
        del hs, b_t
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0], h


def apply_ssm(p: dict, x: Tensor, cfg, state: SSMState, chunk: int = 1024,
              taps=None, quantize_cb=None) -> Tuple[Tensor, SSMState]:
    """x: (B, T, d) -> (y (B, T, d), new_state). Taps "ssm_in" (feeds
    w_in) and "ssm_out_in" (feeds w_out); `quantize_cb` as in
    `transformer.layer_full`."""
    B, T, _ = x.shape
    cd = x.dtype
    if taps is not None:
        taps["ssm_in"] = x
        if quantize_cb is not None:
            p = {**p, **quantize_cb("ssm_in")}
    xz = torch.einsum("btd,de->bte", x, p["w_in"].to(cd))
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, conv_state = _causal_conv(p, xi, state.conv)
    xi = F.silu(xi)

    C = min(chunk, T)
    while T % C:
        C //= 2
    sel = {k: p[k] for k in ("w_xproj", "w_dt", "b_dt", "a_log")}
    y, h_final = _ssm_recurrence(sel, xi, state.h.float(), cfg=cfg, chunk=C)
    y = y + p["d_skip"].float() * xi.float()
    y = y.to(cd) * F.silu(z)
    if taps is not None:
        taps["ssm_out_in"] = y
        if quantize_cb is not None:
            p = {**p, **quantize_cb("ssm_out_in")}
    out = torch.einsum("bte,ed->btd", y, p["w_out"].to(cd))
    return out, SSMState(h=h_final.to(state.h.dtype), conv=conv_state)


def decode_ssm(p: dict, x: Tensor, cfg, state: SSMState
               ) -> Tuple[Tensor, SSMState]:
    """One token. x: (B, 1, d)."""
    return apply_ssm(p, x, cfg, state, chunk=1)
