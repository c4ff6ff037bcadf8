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
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import quant_matmul as _qmm

Tensor = torch.Tensor


def _plain(t: Tensor) -> bool:
    return t.device.type == "cpu"


def comq_panel_dq(h_bb: Tensor, s0: Tensor, qf: Tensor, delta, z_lo, z_hi,
                  hdiag: Tensor):
    """Fused intra-panel sweep returning (qf', ΔW) — the blocked solvers'
    default `panel_fn`; operands with a leading expert axis sweep every
    expert's panel in one call."""
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


def paged_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                    block_tables: Tensor, lengths: Tensor, *,
                    window: int = 0) -> Tensor:
    """Decode attention over a paged KV pool (serve/kv_cache.py layout):
    q (B, H, hd), one query token per slot; block_tables (B, MAXB)
    physical page ids; lengths (B,) valid tokens (0 = inactive slot)."""
    if _plain(q):
        return _paged.paged_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, window=window)
    return _paged.paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                       lengths, window=window)


def paged_attention_quant(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                          k_scale: Tensor, v_scale: Tensor,
                          block_tables: Tensor, lengths: Tensor, *,
                          window: int = 0, kv_bits: int = 8) -> Tensor:
    """Decode attention over a quantized paged pool: integer codes (int8 /
    packed 4-bit) with (NB, KV) per-page scales, dequantized inside the
    kernel."""
    if _plain(q):
        return _paged.paged_attention_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
            window=window, kv_bits=kv_bits)
    return _paged.paged_attention_quant_cuda(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
        window=window, kv_bits=kv_bits)


# every kernel: (module, its name attribute, its launch-counter attribute)
KERNELS = ((_panel, "NAME", "launches"), (_flash, "NAME", "launches"),
           (_qmm, "NAME", "launches"), (_paged, "NAME", "launches"),
           (_paged, "NAME_QUANT", "launches_quant"))


def reset_launch_counts() -> None:
    for mod, _, count in KERNELS:
        setattr(mod, count, 0)
    _paged.launches_quant_tc = 0     # the tensor-core share of launches_quant
    _panel.launches_batched = 0      # the expert-batched share of launches
    _flash.launches_single_query = 0     # the Tq = 1 share of launches
    _qmm.launches_by_cpb = dict.fromkeys(_qmm.launches_by_cpb, 0)


def launch_counts() -> dict:
    return {getattr(mod, name): getattr(mod, count)
            for mod, name, count in KERNELS}
