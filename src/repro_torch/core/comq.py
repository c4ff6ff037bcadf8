"""COMQ result container and coordinate visit orders (port of the parts of
`repro.core.comq` the H-space and blocked solvers use; the X-space solver
is not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
