"""Plain-torch oracle of `repro.kernels.ref.quant_matmul_ref`, the
arithmetic of `quant_matmul`'s plain version. (The plain attention is the
port of `ref.flash_attention_ref` in the model's layout:
`kernels/flash_attention.flash_attention_plain`; the plain panel sweep is
`core/comq_hessian.panel_sweep_dq_ref`.)"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def quant_matmul_ref(x: Tensor, codes_u: Tensor, scale: Tensor, z_lo: Tensor,
                     out_dtype=torch.float32) -> Tensor:
    """x: (M, K); codes_u: (K, N) uint8 offset-binary; scale/z_lo: (N,).

    Y = X · W_q,  W_q[k, n] = scale[n] · (codes_u[k, n] + z_lo[n])."""
    w = (codes_u.float() + z_lo.float()) * scale
    return (x.float() @ w).to(out_dtype)

