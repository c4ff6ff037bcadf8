"""Uniform quantization grids, scale/zero-point initialization, packing
(port of `repro.core.quantizer`).

b-bit asymmetric uniform quantization with bit-code set
S = {z, z+1, ..., z + 2^b - 1} and W_q = δ·Q.

* per-layer  (Alg. 1): one shared δ; δ⁰ = mean_j ‖w_j‖∞ / 2^{b-1},
  z = -2^{b-1}.
* per-channel (Alg. 2): δ_j = λ·(max w_j - min w_j)/(2^b - 1),
  z_j = round(min w_j / δ_j).

`torch.round` rounds half to even, as `jnp.round` does, so grids and RTN
codes match the JAX package exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

Tensor = torch.Tensor
EPS = 1e-12


@dataclass(frozen=True)
class QuantSpec:
    bits: int = 4
    granularity: str = "per_channel"      # per_channel | per_layer
    lam: float = 1.0                      # λ init shrink (per-channel)
    sweeps: int = 3                       # K in the paper
    order: str = "greedy"                 # greedy | cyclic | greedy_shared

    @property
    def n_levels(self) -> int:
        return 2 ** self.bits


def init_per_layer(w: Tensor, bits: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (delta0, z_lo, z_hi), scalars for w: (m, n); for a stack
    (..., m, n) one grid per matrix, each of shape (...)."""
    col_inf = w.abs().amax(dim=-2)
    delta0 = torch.clamp(col_inf.mean(dim=-1) / (2.0 ** (bits - 1)),
                         min=EPS)
    z = -(2 ** (bits - 1))
    kw = dict(dtype=torch.int32, device=w.device)
    z_lo = torch.full(tuple(w.shape[:-2]), z, **kw)
    return delta0, z_lo, z_lo + 2 ** bits - 1


def init_per_channel(w: Tensor, bits: int, lam: float
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (delta0 (n,), z_lo (n,), z_hi (n,)) for w: (m, n); for a
    stack (..., m, n) one grid per matrix, each (..., n)."""
    wmax = w.amax(dim=-2)
    wmin = w.amin(dim=-2)
    delta0 = torch.clamp(lam * (wmax - wmin) / (2.0 ** bits - 1.0), min=EPS)
    z_lo = torch.round(wmin / delta0).to(torch.int32)
    return delta0, z_lo, z_lo + 2 ** bits - 1


def quantize_rtn(w: Tensor, delta: Tensor, z_lo: Tensor, z_hi: Tensor
                 ) -> Tensor:
    """Round-to-nearest onto the grid (baseline + COMQ initialization)."""
    q = torch.round(w / delta)
    return torch.clamp(q, z_lo.float(), z_hi.float()).to(torch.int32)


# ---------------------------------------------------------------------------
# storage: offset-binary codes (codes - z_lo in [0, 2^b-1]) packed for HBM
# ---------------------------------------------------------------------------

def pack_int4(u: Tensor) -> Tensor:
    """Pack uint4 codes (last dim even) into uint8 pairs: low nibble first."""
    if u.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even last dim")
    lo = u[..., 0::2].to(torch.uint8)
    hi = u[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(b: Tensor) -> Tensor:
    lo = b & 0x0F
    hi = (b >> 4) & 0x0F
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*b.shape[:-1], b.shape[-1] * 2)


def pack_int2(u: Tensor) -> Tensor:
    """Pack uint2 codes (last dim % 4 == 0) four per byte, lowest bits
    first."""
    if u.shape[-1] % 4:
        raise ValueError("pack_int2 needs last dim % 4 == 0")
    parts = [u[..., i::4].to(torch.uint8) << (2 * i) for i in range(4)]
    return parts[0] | parts[1] | parts[2] | parts[3]


def unpack_int2(b: Tensor) -> Tensor:
    parts = [(b >> (2 * i)) & 0x03 for i in range(4)]
    out = torch.stack(parts, dim=-1)
    return out.reshape(*b.shape[:-1], b.shape[-1] * 4)


def codes_per_byte(bits: int) -> int:
    """2-bit codes pack four per byte, 3/4-bit codes two per byte, 5..8-bit
    codes pass through one per byte."""
    if bits <= 2:
        return 4
    if bits <= 4:
        return 2
    return 1


def pack_codes(u: Tensor, bits: int):
    """Pack offset-binary uint8 codes to the densest layout their width
    allows. Returns (packed, cpb); cpb is 1 when the last dim does not
    align to the pack width (the codes are then stored unpacked)."""
    cpb = codes_per_byte(bits)
    if cpb == 1 or u.shape[-1] % cpb:
        return u.to(torch.uint8), 1
    if cpb == 4:
        return pack_int2(u), 4
    return pack_int4(u), 2


def unpack_codes(b: Tensor, cpb: int) -> Tensor:
    """Inverse of pack_codes for a known codes-per-byte."""
    if cpb == 4:
        return unpack_int2(b)
    if cpb == 2:
        return unpack_int4(b)
    return b

