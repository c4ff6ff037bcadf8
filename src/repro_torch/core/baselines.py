"""Baselines the paper compares against (port of `repro.core.baselines`):
RTN, which also gives the pipeline's `err_before`, and a GPTQ/OBQ-style
Hessian solver. Both share COMQ's grid initialization."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comq import QuantResult
from repro_torch.core.comq_hessian import _h_error, _init_grid
from repro_torch.core.guards import damped_inverse
from repro_torch.core.quantizer import EPS, QuantSpec, quantize_rtn

Tensor = torch.Tensor


def rtn_quantize(w: Tensor, spec: QuantSpec,
                 h: Optional[Tensor] = None) -> QuantResult:
    """Round-to-nearest onto the COMQ grid (no data)."""
    w = w.float()
    delta, z_lo, z_hi = _init_grid(w, spec)
    q = quantize_rtn(w, delta, z_lo, z_hi)
    err = (_h_error(h, w, q.float() * delta) if h is not None
           else torch.zeros((), device=w.device))
    return QuantResult(q=q, delta=delta, z_lo=z_lo, z_hi=z_hi,
                       errors=err[None])


def gptq_quantize(h: Tensor, w: Tensor, spec: QuantSpec,
                  damping: float = 0.01) -> QuantResult:
    """GPTQ/OBQ baseline: sequential rounding over the input dimension with
    OBS error propagation through H⁻¹, on a fixed grid (no δ-updates)."""
    h = h.float()
    w = w.float()
    m, n = w.shape
    delta, z_lo, z_hi = _init_grid(w, spec)
    zlo, zhi = z_lo.float(), z_hi.float()
    diag = torch.diagonal(h)
    diag_mean = diag.mean()
    dead = diag <= EPS
    h = h + torch.diag(dead.float())
    hinv, _ = damped_inverse(h, start=damping, diag_mean=diag_mean)
    h = h + torch.eye(m, device=h.device) * damping * diag_mean

    w0 = w
    w = w.clone()                       # propagated in place below
    qf = torch.zeros_like(w)
    for i in range(m):
        wi = w[i]
        qi = torch.clamp(torch.round(wi / delta), zlo, zhi)
        err = (wi - qi * delta) / hinv[i, i]
        # propagate to not-yet-quantized rows (> i); rows <= i are frozen
        w[i + 1:] -= hinv[i + 1:, i][:, None] * err[None, :]
        qf[i] = qi
    err = _h_error(h, w0, qf * delta)
    return QuantResult(q=qf.to(torch.int32), delta=delta, z_lo=z_lo,
                       z_hi=z_hi, errors=err[None])
