"""COMQ — coordinate-wise minimization of ‖X W_q − X W‖² (port of
`repro.core.comq`): the result container, the coordinate visit orders the
H-space and blocked solvers share, and the paper-faithful X-space solver
`comq_quantize`.

The X-space solver carries the residual U = X(W − W_q) in sample space
and performs the vectorized row updates of eq. (6) (per-layer, Alg. 1) /
eq. (9) (per-channel, Alg. 2), from the float init Q⁰ = W/δ⁰, with the
closed-form δ-updates eq. (7)/(10). It is a library function in plain
torch (the JAX package runs its sweep as a `fori_loop`); the pipeline's
solvers at scale are the H-space ones in core/comq_hessian.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.quantizer import EPS, QuantSpec, init_per_channel, \
    init_per_layer

Tensor = torch.Tensor


@dataclass
class QuantResult:
    q: Tensor           # (m, n) int32 bit-codes in [z_lo, z_hi]
    delta: Tensor       # scalar (per-layer) or (n,) (per-channel)
    z_lo: Tensor
    z_hi: Tensor
    errors: Tensor      # (sweeps+1,) ‖X(W − W_q)‖ trajectory


def make_orders(order: str, x_col_norms: Tensor, w: Tensor) -> Tensor:
    """Returns (m, n) int64: orders[t, j] = coordinate visited at step t in
    column j. Greedy = descending ‖x_i‖·|w_ij| (paper §3.3).

    The sorts are stable, like `jnp.argsort`, so tied keys are visited in
    index order in both packages."""
    m, n = w.shape
    if order == "cyclic":
        return torch.arange(m, device=w.device)[:, None].expand(m, n)
    if order == "greedy":
        keys = x_col_norms[:, None] * w.abs()
        return torch.argsort(-keys, dim=0, stable=True)
    if order == "greedy_shared":
        keys = x_col_norms * torch.sqrt(torch.sum(w * w, dim=1))
        shared = torch.argsort(-keys, stable=True)
        return shared[:, None].expand(m, n)
    raise ValueError(f"unknown order {order!r}")


# ---------------------------------------------------------------------------
# the X-space coordinate-descent sweep (per-layer and per-channel)
# ---------------------------------------------------------------------------

def _sweep(x: Tensor, u: Tensor, qf: Tensor, delta: Tensor, z_lo, z_hi,
           orders: Tensor, xsq: Tensor):
    """One pass over all m coordinates (rows), vectorized over columns.

    u: (N, n) residual X(W − δ·Q); qf: (m, n) codes (float during sweep
    1); delta/z_lo/z_hi: scalar or (n,). Updates u and qf in place."""
    m, n = qf.shape
    cols = torch.arange(n, device=qf.device)
    zlo, zhi = z_lo.float(), z_hi.float()
    for t in range(m):
        idx = orders[t]                                   # (n,)
        xg = x[:, idx]                                    # (N, n) gather
        qg = qf[idx, cols]
        xsq_g = xsq[idx]
        denom = delta * xsq_g
        # ⟨x_i, s_i⟩ / (δ‖x_i‖²) = ⟨x_i, u_j⟩/(δ‖x_i‖²) + q_old
        ratio = torch.sum(xg * u, dim=0) / torch.where(
            denom > 0, denom, torch.ones_like(denom))
        q_new = torch.clamp(torch.round(ratio + qg), zlo, zhi)
        q_new = torch.where(xsq_g > EPS, q_new,
                            torch.clamp(torch.round(qg), zlo, zhi))
        du = (q_new - qg) * delta
        u -= xg * du[None, :]
        qf[idx, cols] = q_new
    return u, qf


def _delta_update_per_layer(x: Tensor, w: Tensor, qf: Tensor) -> Tensor:
    xq = x @ qf
    num = torch.sum(xq * (x @ w))
    den = torch.sum(xq * xq)
    return torch.where(den > EPS, num / den, torch.ones_like(den))  # (7)


def _delta_update_per_channel(x: Tensor, w: Tensor, qf: Tensor) -> Tensor:
    xq = x @ qf                                           # (N, n)
    num = torch.sum(xq * (x @ w), dim=0)
    den = torch.sum(xq * xq, dim=0)
    return torch.where(den > EPS, num / den, torch.ones_like(den))  # (10)


def _comq_x_core(x: Tensor, w: Tensor, *, spec: QuantSpec):
    if spec.granularity == "per_layer":
        delta, z_lo, z_hi = init_per_layer(w, spec.bits)
    else:
        delta, z_lo, z_hi = init_per_channel(w, spec.bits, spec.lam)
    xsq = torch.sum(x * x, dim=0)                         # ‖x_i‖² (m,)
    orders = make_orders(spec.order, torch.sqrt(xsq), w)
    qf = w / delta                                        # float Q⁰ = W/δ⁰
    xw = x @ w
    errs = [torch.linalg.norm(xw - x @ (qf * delta))]
    for _ in range(spec.sweeps):
        u = xw - x @ (qf * delta)                         # U₀ = X(W − δQ)
        u, qf = _sweep(x, u, qf, delta, z_lo, z_hi, orders, xsq)
        if spec.granularity == "per_layer":
            delta = _delta_update_per_layer(x, w, qf)
        else:
            delta = _delta_update_per_channel(x, w, qf)
        errs.append(torch.linalg.norm(xw - x @ (qf * delta)))
    q = torch.clamp(torch.round(qf), z_lo.float(), z_hi.float()).to(
        torch.int32)
    return q, delta, z_lo, z_hi, torch.stack(errs)


def comq_quantize(x: Tensor, w: Tensor, spec: QuantSpec) -> QuantResult:
    """Quantize one linear layer's weight w: (m, n) given features x:
    (N, m), following Alg. 1 (per-layer) / Alg. 2 (per-channel) with
    K = spec.sweeps."""
    q, delta, z_lo, z_hi, errs = _comq_x_core(x.float(), w.float(),
                                              spec=spec)
    return QuantResult(q=q, delta=delta, z_lo=z_lo, z_hi=z_hi, errors=errs)
