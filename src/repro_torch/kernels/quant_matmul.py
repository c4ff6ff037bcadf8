"""`quant_matmul`: the dequant-fused GEMM every packed projection of the
decode path runs — Hopper kernel (csrc/quant_matmul.cu) and its plain
version.

Replaces the Pallas TPU kernel `src/repro/kernels/quant_matmul.py`
(`quant_matmul_pallas`):

    Y[m, n] = scale[n] · (Σ_k X[m, k]·u[k, n] + z[n]·Σ_k X[m, k])

with u the offset-binary codes, packed along N at cpb 1, 2 (low nibble
first) or 4 (2-bit fields, lowest first) and unpacked in registers.

Input precision: f32 X times exact integer codes, accumulated in f32 on
the CUDA cores (the TPU kernel cast X to bf16 for the MXU). The plain
version dequantizes and runs the f32 product, so the two differ only in
summation order and in where the zero-point is applied: tolerance
max|Δ| ≤ 1e-3 · max|Y|.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizer import unpack_codes
from repro_torch.kernels import build, ref

Tensor = torch.Tensor
NAME = "quant_matmul"
launches = 0     # kernel launches since the last reset (chip_smoke reads it)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_MT, _KT = 8, 256    # rows of X and k rows per chunk of one block (csrc)


def quant_matmul_plain(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor,
                       *, cpb: int) -> Tensor:
    """Unpack, then the f32 product of `ref.quant_matmul_ref`."""
    return ref.quant_matmul_ref(x, unpack_codes(codes, cpb), scale, z_lo)


def split_k(M: int, K: int, NB: int, n_sm: int) -> int:
    """Number of K splits: enough blocks for two waves over the SMs, each
    split at least one 256-row chunk."""
    tiles = -(-NB // 32) * -(-M // _MT)
    return max(1, min(-(-2 * n_sm // tiles), -(-K // _KT)))


def quant_matmul_cuda(x: Tensor, codes: Tensor, scale: Tensor, z_lo: Tensor,
                      *, cpb: int) -> Tensor:
    """Launch the kernel: x (M, K) f32, codes (K, N/cpb) uint8, scale/z_lo
    (N,) f32 -> (M, N) f32."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"quant_matmul kernel needs CUDA tensors, got "
                           f"{dev}")
    if cpb not in (1, 2, 4):
        raise ValueError(f"quant_matmul: cpb must be 1, 2 or 4, got {cpb}")
    M, K = x.shape
    NB = codes.shape[1]
    N = NB * cpb
    for name, t, shape, dtype in (("x", x, (M, K), torch.float32),
                                  ("codes", codes, (K, NB), torch.uint8),
                                  ("scale", scale, (N,), torch.float32),
                                  ("z_lo", z_lo, (N,), torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"quant_matmul: {name} must be {dtype} on {dev}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ksplit = split_k(M, K, NB, n_sm)
    kc = -(-K // ksplit)
    y = torch.empty(M, N, dtype=torch.float32, device=dev)
    part = torch.empty(ksplit, M, N, dtype=torch.float32, device=dev)
    part_rs = torch.empty(ksplit, M, dtype=torch.float32, device=dev)
    fn = build.load(NAME, "quant_matmul", _ARGTYPES)
    rc = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), z_lo.data_ptr(),
            y.data_ptr(), part.data_ptr(), part_rs.data_ptr(), M, K, NB, cpb,
            ksplit, kc, torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    launches += 1
    return y
