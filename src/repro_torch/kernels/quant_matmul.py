"""`quant_matmul`: the dequant-fused GEMM every packed projection of the
decode path runs — Hopper kernel (csrc/quant_matmul.cu) and its plain
version.

Replaces the Pallas TPU kernel `src/repro/kernels/quant_matmul.py`
(`quant_matmul_pallas`):

    Y[m, n] = scale[n] · (Σ_k X[m, k]·u[k, n] + z[n]·Σ_k X[m, k])

with u the offset-binary codes, packed along N at cpb 1, 2 (low nibble
first) or 4 (2-bit fields, lowest first) and unpacked in registers.

Input precision: the kernel runs on the bf16 tensor cores. Codes are
exact in bf16; an f32 X is first split into three bf16 planes hi + mid +
lo (x to ~2^-24, three mmas a step), a bf16 X goes in as it is (one mma),
and the sums, the rowsum ΣX and the epilogue are f32. The products are
exact, so kernel and plain version (which dequantizes and runs the f32
product) differ in summation order and where the zero-point is applied:
tolerance max|Δ| ≤ 1e-3 · max|Y|. `core/apply.qt_linear` hands bf16
activations over as they are; Y is f32 either way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.quantizer import unpack_codes
from repro_torch.kernels import build, ref

Tensor = torch.Tensor
NAME = "quant_matmul"
launches = 0     # kernel launches since the last reset (chip_smoke reads it)
launches_by_cpb = {1: 0, 2: 0, 4: 0}   # the same launches by code packing

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
X_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, NB: int, cpb: int, x_bf16: bool,
         n_sm: int) -> Tuple[int, int, int, int]:
    """The kernel's own launch plan for a call (csrc/quant_matmul.cu
    `make_plan`): (1 for the M ≥ 64 tiles else 0, ksplit, kc, workspace
    floats). Needs the built library, so it runs only on the card."""
    out = (ctypes.c_longlong * 4)()
    fn = build.load(NAME, "quant_matmul_plan", _PLAN_ARGTYPES)
    build.check(NAME, fn(M, K, NB, cpb, int(x_bf16), n_sm, out))
    return tuple(out)


_WORKSPACE: Dict[Tuple[int, int], Tensor] = {}   # (device, stream) -> f32


def _workspace(dev: torch.device, numel: int) -> Tensor:
    """Scratch of at least `numel` floats for a call on the current stream.
    Eager calls share their stream's buffer in stream order; it grows
    (never shrinks) as calls need more. A call captured into a CUDA graph
    takes a buffer of its own, from the graph's memory pool, so a replay
    never writes into a buffer that a later, larger call has let go."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(numel, dtype=torch.float32, device=dev)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=dev)
        _WORKSPACE[key] = buf
    return buf


def quant_matmul_plain(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor,
                       *, cpb: int) -> Tensor:
    """Unpack, then the f32 product of `ref.quant_matmul_ref` (x f32 or
    bf16, taken to f32)."""
    return ref.quant_matmul_ref(x, unpack_codes(codes, cpb), scale, z_lo)


def quant_matmul_cuda(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor,
                      *, cpb: int) -> Tensor:
    """Launch the kernel: x (M, K) f32 or bf16, codes (K, N/cpb) uint8,
    scale/z_lo (N,) f32 -> (M, N) f32."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"quant_matmul kernel needs CUDA tensors, got "
                           f"{dev}")
    if cpb not in (1, 2, 4):
        raise ValueError(f"quant_matmul: cpb must be 1, 2 or 4, got {cpb}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"quant_matmul: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    M, K = x.shape
    NB = codes.shape[1]
    N = NB * cpb
    for name, t, shape, dtype in (("x", x, (M, K), x.dtype),
                                  ("codes", codes, (K, NB), torch.uint8),
                                  ("scale", scale, (N,), torch.float32),
                                  ("z_lo", z_lo, (N,), torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"quant_matmul: {name} must be {dtype} on {dev}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if M == 0 or K == 0 or N == 0:
        raise ValueError(f"quant_matmul: empty operand, M={M} K={K} N={N}")
    x_bf16 = x.dtype == torch.bfloat16
    n_sm = build.sm_count(dev.index)
    ws_floats = plan(M, K, NB, cpb, x_bf16, n_sm)[3]
    ws = _workspace(dev, ws_floats).data_ptr() if ws_floats else 0
    y = torch.empty(M, N, dtype=torch.float32, device=dev)
    fn = build.load(NAME, "quant_matmul", _ARGTYPES)
    rc = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), z_lo.data_ptr(),
            y.data_ptr(), ws, ws_floats, M, K, NB, cpb, int(x_bf16), n_sm,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    launches += 1
    launches_by_cpb[cpb] += 1
    return y
