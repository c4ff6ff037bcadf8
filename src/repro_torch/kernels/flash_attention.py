"""`flash_attention`: block-causal (+ sliding-window) GQA attention over the
model's (B, T, H, hd) layout — Hopper kernel (csrc/flash_attention.cu) and
its plain version.

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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
NAME = "flash_attention"
NEG_INF = -1e30
launches = 0     # kernel launches since the last reset (chip_smoke reads it)
launches_single_query = 0     # the share with Tq = 1 (a cross decode step)

_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


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


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int = 0) -> Tensor:
    """Launch the kernel on (B, Tq, H, hd) / (B, Tk, KV, hd) tensors."""
    global launches, launches_single_query
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
    o = torch.empty(B, Tq, H, hd, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, o)
                                         for i in range(3)])
    fn = build.load(NAME, "flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.addressof(strides), _DTYPES[q.dtype], B, Tq, Tk, H, KV,
            hd, int(causal), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    launches += 1
    launches_single_query += Tq == 1
    return o
