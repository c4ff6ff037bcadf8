"""Kernel dispatch by tensor device only (port of `repro.kernels.ops`).

A CPU tensor goes to the kernel's plain version; any other tensor goes to
the Hopper kernel, which launches or raises. The attention entry points
take a `head_map` (a host tuple of each query head's KV head; None, or
the even map h // (H // KV), needs no table): the kernels read its
device table, built once per (map, device) by `kernels/headmap.py`, so
a decode step copies nothing from the host; the plain versions expand
K/V by it. There is no fallback from the
kernel to the plain version and no switch that selects the plain version
for a CUDA tensor. Kernels are built and imported at first launch, never
when this module is imported.

Under a running `roofline.analysis.count_cost` each call charges its
kernel's cost function (`roofline/kernels.py`) and keeps the ops it runs,
the plain version's included, out of the count: a call costs the same on
the CPU as on the card, and on meta tensors (the plain version then
gives the output's shape). On the CPU under autograd the plain attention
then runs as `_CountedPlainAttention`, whose backward charges the
backward kernel's cost; outside a count nothing changes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import comq_panel as _panel
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import quant_matmul as _qmm
from repro_torch.roofline import kernels as _cost
from repro_torch.roofline.analysis import charged, counting

Tensor = torch.Tensor


def _plain(t: Tensor) -> bool:
    """CPU tensors take the plain version; so do meta tensors under a
    running count, which then only needs the output's shape."""
    return t.device.type == "cpu" or (t.device.type == "meta"
                                      and counting())


def comq_panel_dq(h_bb: Tensor, s0: Tensor, qf: Tensor, delta, z_lo, z_hi,
                  hdiag: Tensor):
    """Fused intra-panel sweep returning (qf', ΔW) — the blocked solvers'
    default `panel_fn`; operands with a leading expert axis sweep every
    expert's panel in one call."""
    with charged(_cost.comq_panel_of, h_bb, s0, qf):
        if _plain(qf):
            return _panel.comq_panel_dq_plain(h_bb, s0, qf, delta, z_lo,
                                              z_hi, hdiag)
        return _panel.comq_panel_dq_cuda(h_bb, s0, qf, delta, z_lo, z_hi,
                                         hdiag)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, head_map=None) -> Tensor:
    """q (B, Tq, H, hd), k/v (B, Tk, KV, hd) -> (B, Tq, H, hd) q.dtype.
    Differentiable: on the CPU through the plain version's autograd
    graph, on the card through the forward kernel (with LSE) and the
    backward kernel."""
    with charged(_cost.flash_attention_of, q, k, causal=causal,
                 window=window):
        if not _plain(q):
            return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window,
                                               head_map=head_map)
        if counting() and _needs_grad(q, k, v):
            return _CountedPlainAttention.apply(q, k, v, causal, window,
                                                head_map)
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, head_map=head_map)


def quant_matmul(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor, *,
                 cpb: int) -> Tensor:
    """Y = X · (scale ⊙ (codes + z)) in f32; codes packed `cpb` per byte."""
    with charged(_cost.quant_matmul_of, x, codes, cpb=cpb):
        if _plain(x):
            return _qmm.quant_matmul_plain(x, codes, scale, z_lo, cpb=cpb)
        return _qmm.quant_matmul_cuda(x, codes, scale, z_lo, cpb=cpb)


def paged_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                    block_tables: Tensor, lengths: Tensor, *,
                    window: int = 0, head_map=None) -> Tensor:
    """Decode attention over a paged KV pool (serve/kv_cache.py layout):
    q (B, H, hd), one query token per slot; block_tables (B, MAXB)
    physical page ids; lengths (B,) valid tokens (0 = inactive slot)."""
    with charged(_cost.paged_attention_of, q, k_pool, block_tables, lengths,
                 window=window):
        if _plain(q):
            return _paged.paged_attention_plain(q, k_pool, v_pool,
                                                block_tables, lengths,
                                                window=window,
                                                head_map=head_map)
        return _paged.paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                           lengths, window=window,
                                           head_map=head_map)


def paged_attention_quant(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                          k_scale: Tensor, v_scale: Tensor,
                          block_tables: Tensor, lengths: Tensor, *,
                          window: int = 0, kv_bits: int = 8,
                          head_map=None) -> Tensor:
    """Decode attention over a quantized paged pool: integer codes (int8 /
    packed 4-bit) with (NB, KV) per-page scales, dequantized inside the
    kernel."""
    with charged(_cost.paged_attention_of, q, k_pool, block_tables, lengths,
                 window=window, kv_bits=kv_bits):
        if _plain(q):
            return _paged.paged_attention_quant_plain(
                q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
                window=window, kv_bits=kv_bits, head_map=head_map)
        return _paged.paged_attention_quant_cuda(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
            window=window, kv_bits=kv_bits, head_map=head_map)


def adamw_update_leaf(p: Tensor, g: Tensor, m, v, *, lr: Tensor, c1: Tensor,
                      c2: Tensor, cfg, factor=None) -> None:
    """One leaf's AdamW update in place: p and its moments (f32 tensors,
    or int8 codec dicts when `cfg.moment_dtype` is "int8") from gradient
    `g`, times the clip `factor` (a 0-d tensor) when given; lr and the
    bias corrections c1, c2 are 0-d f32 tensors on p's device."""
    with charged(_cost.adamw_update_of, p, m):
        if _plain(p):
            return _adamw.adamw_leaf_plain(p, g, m, v, lr=lr, c1=c1, c2=c2,
                                           cfg=cfg, factor=factor)
        return _adamw.adamw_leaf_cuda(p, g, m, v, lr=lr, c1=c1, c2=c2,
                                      cfg=cfg, factor=factor)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _CountedPlainAttention(torch.autograd.Function):
    """The plain attention on CPU tensors under a running count: the
    forward as `flash_attention_plain`, the backward its autograd graph
    recomputed, charged as the backward kernel (the ops inside uncounted).
    The same ops as the direct graph, so the same gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, head_map=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.head_map = causal, window, head_map
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, head_map=head_map)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with charged(_cost.flash_attention_bwd_of, q, k, causal=ctx.causal,
                     window=ctx.window), torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _flash.flash_attention_plain(*leaves, causal=ctx.causal,
                                               window=ctx.window,
                                               head_map=ctx.head_map)
            grads = torch.autograd.grad(out, leaves, do)
        return (*grads, None, None, None)


# every kernel: (module, its name attribute, its launch-counter attribute)
KERNELS = ((_panel, "NAME", "launches"), (_flash, "NAME", "launches"),
           (_qmm, "NAME", "launches"), (_paged, "NAME", "launches"),
           (_paged, "NAME_QUANT", "launches_quant"),
           (_flash, "NAME_BWD", "launches_bwd"),
           (_adamw, "NAME", "launches"))


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


# every counter a launch moves: each kernel's, and the shares counted apart
_COUNTERS = tuple((mod, count) for mod, _, count in KERNELS) + (
    (_paged, "launches_quant_tc"), (_panel, "launches_batched"),
    (_flash, "launches_single_query"))


def launch_state() -> dict:
    """Every launch counter, quant_matmul's by code packing included: what
    a CUDA-graph capture diffs to learn the launches it holds."""
    state = {(mod.__name__, count): getattr(mod, count)
             for mod, count in _COUNTERS}
    state.update({("cpb", cpb): n for cpb, n in _qmm.launches_by_cpb.items()})
    return state


def add_launches(delta: dict) -> None:
    """Add `delta` (a difference of two `launch_state`s) to the counters:
    a graph replay launches what its capture recorded, and no wrapper runs
    to count it."""
    mods = {mod.__name__: mod for mod, _ in _COUNTERS}
    for (where, key), n in delta.items():
        if where == "cpb":
            _qmm.launches_by_cpb[key] = _qmm.launches_by_cpb.get(key, 0) + n
        else:
            setattr(mods[where], key, getattr(mods[where], key) + n)
