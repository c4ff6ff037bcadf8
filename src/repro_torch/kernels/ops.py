"""Kernel dispatch by tensor device only (port of `repro.kernels.ops`).

A CPU tensor goes to the kernel's plain version; any other tensor goes to
the Hopper kernel, which launches or raises. There is no fallback from the
kernel to the plain version and no switch that selects the plain version
for a CUDA tensor. Kernels are built and imported at first launch, never
when this module is imported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import comq_panel as _panel
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quant_matmul as _qmm

Tensor = torch.Tensor


def _plain(t: Tensor) -> bool:
    return t.device.type == "cpu"


def comq_panel_dq(h_bb: Tensor, s0: Tensor, qf: Tensor, delta, z_lo, z_hi,
                  hdiag: Tensor):
    """Fused intra-panel sweep returning (qf', ΔW) — the blocked solver's
    default `panel_fn`."""
    if _plain(qf):
        return _panel.comq_panel_dq_plain(h_bb, s0, qf, delta, z_lo, z_hi,
                                          hdiag)
    return _panel.comq_panel_dq_cuda(h_bb, s0, qf, delta, z_lo, z_hi, hdiag)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """q (B, Tq, H, hd), k/v (B, Tk, KV, hd) -> (B, Tq, H, hd) q.dtype."""
    if _plain(q):
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


def quant_matmul(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor, *,
                 cpb: int) -> Tensor:
    """Y = X · (scale ⊙ (codes + z)) in f32; codes packed `cpb` per byte."""
    if _plain(x):
        return _qmm.quant_matmul_plain(x, codes, scale, z_lo, cpb=cpb)
    return _qmm.quant_matmul_cuda(x, codes, scale, z_lo, cpb=cpb)


KERNELS = (_panel, _flash, _qmm)


def reset_launch_counts() -> None:
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.NAME: mod.launches for mod in KERNELS}
