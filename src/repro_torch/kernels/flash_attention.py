"""`flash_attention`: block-causal (+ sliding-window) GQA attention over the
model's (B, T, H, hd) layout — Hopper kernels (csrc/flash_attention.cu and,
for its gradient, csrc/flash_attention_bwd.cu) and its plain version.

Replaces the Pallas TPU kernel `src/repro/kernels/flash_attention.py`
(`flash_attention_pallas`). The kernel reads q (B, Tq, H, hd) and k/v
(B, Tk, KV, hd) through their strides (no transpose to (BH, T, hd) in
device memory) and maps query head h to KV head h // (H // KV); the group
need not be a power of two (qwen2: 7).

Dispatch by dtype: bf16 q/k/v run the tensor-core kernel (mma.sync bf16
with f32 accumulation, K/V through a 2-stage cp.async ring; needs an even
hd), f32 the CUDA-core kernel. The source states the design.

Tolerance against the plain version: both compute the softmax in f32 from
the same inputs and differ only in summation order, exp's last bits and,
for bf16, P carried into P·V as bf16 hi + lo (~16 bits), so a bf16 output
may round the other way: |Δ| ≤ 8e-3·|want| + 1e-3 for bf16 (two bf16
ulps) and ≤ 1e-4 + 1e-4·|want| for f32.

Gradient. Under autograd (grad enabled and q, k or v requiring grad) a
CUDA call runs `FlashAttention`: the forward kernel also writes each
row's log-sum-exp (LSE, (B, H, Tq) f32), and the backward recomputes P
from it tile by tile (FlashAttention-2; the JAX package has no backward
kernel: XLA differentiates its checkpointed pair-scan). It sums D =
rowsum(P·dP) in f32 as the softmax's autograd does, not from the stored
output. Dispatch by dtype, as the forward's:
- bf16: tensor cores (mma.sync bf16, f32 accumulation). Kernel A, a
  block per 64 query rows of a head, streams K/V twice: D, then dS and
  dQ. Kernel B, a block per (64 keys of a KV head, split), walks its
  share of the group's (query head, 64-row tile) pairs for dK and dV.
  `plan_bwd` picks the split count so that kernel B launches about twice
  as many blocks as the card has SMs; with more than one split the
  partials go to an f32 workspace that kernel C sums in split order. P
  and dS enter the three gradient products as bf16 hi + lo (~16 bits).
  The design runs 12 products of the forward's size against the 5 the
  bound counts (S and dP three times; dQ, dK, dV at two each): its
  ceiling is 2.4x the operations bound at the tensor cores' peak.
- f32: CUDA cores (a dq kernel with a D pass, a dkdv kernel), the
  precision path.
A backward launch failure raises; nothing falls back to the plain
version. The plain version of the backward is the autograd graph of
`flash_attention_plain`. Tolerance against it, per gradient g of dQ, dK,
dV: f32 |Δ| ≤ 1e-4·max|g| + 1e-4·|g| (the same products in other
orders); bf16 |Δ| ≤ 2e-2·max|g| + 8e-3·|g| (the kernel rounds each
gradient to bf16 once, the plain graph at every op). The LSE agrees with
`logsumexp` of the plain scaled scores to 1e-4 + 1e-5·|lse| at either
type.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
NAME = "flash_attention"
NEG_INF = -1e30
launches = 0     # kernel launches since the last reset (chip_smoke reads it)
launches_single_query = 0     # the share with Tq = 1 (a cross decode step)
NAME_BWD = "flash_attention_bwd"
launches_bwd = 0    # backward kernel launches since the last reset

_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11
                 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
BWD_TILE = 64        # the bf16 backward's rows a block owns and tile rows


def attention_mask(Tq: int, Tk: int, causal: bool, window: int, device):
    """(Tq, Tk) bool: key s is visible from query t."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        mask = qpos >= kpos
        if window > 0:
            mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: int = 0) -> Tensor:
    """Masked softmax attention in f32 (the port of
    `ref.flash_attention_ref`) in the model's layout: q (B, Tq, H, hd),
    k/v (B, Tk, KV, hd), H % KV == 0. Returns q.dtype."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Tq, KV, G, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float())
    s = s * (1.0 / math.sqrt(hd))
    mask = attention_mask(Tq, Tk, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_lse_plain(q: Tensor, k: Tensor, *, causal: bool = True,
                        window: int = 0) -> Tensor:
    """(B, H, Tq) f32 log-sum-exp of the masked scaled scores: what the
    forward kernel writes beside its output for the backward."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) / math.sqrt(hd)
    mask = attention_mask(Tq, Tk, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Tq)


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Refuse what the kernels do not take."""
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention kernel needs CUDA tensors, got "
                           f"{dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,T,H,hd), k/v "
                         f"(B,T,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV or hd > 256:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (needs "
                         "H % KV == 0 and hd <= 256)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share f32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dtype == torch.bfloat16 and hd % 2:
        raise ValueError(f"flash_attention: the bf16 kernel copies rows in "
                         f"4-byte units and needs an even hd, got {hd}")
    for t in (q, k, v):
        if t.device != dev or t.stride(3) != 1:
            raise ValueError("flash_attention: q/k/v must be on one CUDA "
                             "device with a contiguous head dim")


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
             with_lse: bool):
    """One forward launch: (o, lse (B, H, Tq) f32 or None)."""
    global launches, launches_single_query
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dev = q.device
    o = torch.empty(B, Tq, H, hd, dtype=q.dtype, device=dev)
    lse = (torch.empty(B, H, Tq, dtype=torch.float32, device=dev)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, o)
                                         for i in range(3)])
    fn = build.load(NAME, "flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            ctypes.addressof(strides), _DTYPES[q.dtype], B, Tq, Tk, H, KV,
            hd, int(causal), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    launches += 1
    launches_single_query += Tq == 1
    return o, lse


class BwdPlan(NamedTuple):
    nsplit: int          # query splits of each dK/dV block
    blocks: int          # dK/dV blocks launched


@functools.lru_cache(maxsize=None)
def plan_bwd(B: int, Tq: int, Tk: int, H: int, KV: int, hd: int,
             sms: int) -> BwdPlan:
    """The bf16 backward's split: enough splits that the dK/dV kernel
    launches at least about 2 x `sms` blocks, never more than the (query
    head, 64-row query tile) pairs of a KV head's group (the dims of hd >
    128 go to two blocks already). The kernel walks the pairs that see
    its keys, split s of n taking [s·n_pairs/n, (s+1)·n_pairs/n); a
    split left with none writes zero partials."""
    parts = 2 if hd > 128 else 1
    base = -(-Tk // BWD_TILE) * KV * B * parts
    most = (H // KV) * -(-Tq // BWD_TILE)
    nsplit = max(1, min(most, -(-2 * sms // base)))
    return BwdPlan(nsplit, base * nsplit)


def _row_strides(t: Tensor):
    """Element strides of dims 0-2, 0 for a dim of one: it addresses
    nothing, and autograd may hand over any stride there (an odd one
    would fail the bf16 kernels' 4-byte row copies)."""
    return [t.stride(i) if t.shape[i] > 1 else 0 for i in range(3)]


def flash_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                             lse: Tensor, *, causal: bool = True,
                             window: int = 0):
    """Launch the backward kernels: (dq, dk, dv) in q's dtype from the
    forward's inputs, its LSE and the output's gradient."""
    global launches_bwd
    _check(q, k, v)
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dev = q.device
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    if (do.stride(3) != 1 or do.data_ptr() % 4
            or any(st % 2 for st in _row_strides(do))):
        do = do.clone(memory_format=torch.contiguous_format)
    if (do.shape != q.shape or lse.shape != (B, H, Tq)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("flash_attention backward: want dO like q and a "
                         "contiguous (B, H, Tq) f32 lse")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(B, Tk, KV, hd, dtype=q.dtype, device=dev)
    dv = torch.empty(B, Tk, KV, hd, dtype=q.dtype, device=dev)
    dsum = torch.empty(B, H, Tq, dtype=torch.float32, device=dev)
    nsplit, work = 1, None
    if q.dtype == torch.bfloat16:
        nsplit = plan_bwd(B, Tq, Tk, H, KV, hd,
                          build.sm_count(dev.index)).nsplit
        if nsplit > 1:
            work = torch.empty(2, nsplit, B, Tk, KV, hd,
                               dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 21)(
        *[st for t in (q, k, v, do, dq, dk, dv) for st in _row_strides(t)])
    fn = build.load(NAME_BWD, "flash_attention_bwd", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if work is None else work.data_ptr(),
            ctypes.addressof(strides), _DTYPES[q.dtype], B, Tq, Tk, H, KV,
            hd, int(causal), int(window), nsplit, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME_BWD, rc)
    launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with LSE, saved with q, k and v; the backward
    kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, do, lse,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int = 0) -> Tensor:
    """Launch the kernel on (B, Tq, H, hd) / (B, Tk, KV, hd) tensors;
    under autograd through `FlashAttention` (forward with LSE, backward
    kernel), else the forward alone with no LSE."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    return _forward(q, k, v, causal, window, with_lse=False)[0]
