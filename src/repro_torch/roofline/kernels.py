"""Cost functions of the port's kernels: the work one call needs, from its
shapes alone, whatever runs it (the hand-written kernel, its plain
version, a library call).

Each returns a `KernelCost` (flops, bytes, input type): each input read
once and each output written once, and the operations the algorithm
needs, at the type whose peak bounds them. Where the work depends on the
data (paged attention's live pages), the function takes what this call's
data needs. `bound_ms` turns a cost into the least time the card could
take and says what sets it. The kernel wrappers charge these costs to
`roofline.analysis.count_cost` (`kernels/ops.py`); `chip_smoke.py` prints
them as each kernel's `bound_ms`. `ssm_scan` and `wkv` are the bounds of
two plain PyTorch recurrences that have no kernel in either package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.roofline.analysis import H100, Hardware

Tensor = torch.Tensor


class KernelCost(NamedTuple):
    flops: float
    bytes: float
    kind: str            # input type: "f32", "bf16" or "int8"


def bound_ms(cost: KernelCost, hw: Hardware = H100,
             kind: Optional[str] = None) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak for `kind` (default: the
    cost's own input type)."""
    t_bytes = cost.bytes / hw.hbm_bytes_per_s
    t_ops = cost.flops / hw.peak_flops[kind or cost.kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _kind(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


# ---------------------------------------------------------------------------
# the kernels, by shape
# ---------------------------------------------------------------------------

def comq_panel(B: int, n: int, E: int = 1) -> KernelCost:
    """One panel sweep (E panels in one launch): h_bb, s0, qf, δ, z_lo,
    z_hi and diag(h) in, qf' and ΔW out, f32; B(B-1)/2 multiply-adds a
    column."""
    nbytes = 4 * E * (B * B + 2 * B * n + 3 * n + B) + 4 * 2 * E * B * n
    return KernelCost(E * 2.0 * n * B * (B - 1) / 2, nbytes, "f32")


def attention_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that attention scores."""
    return (sum(min(t + 1, window or Tk) for t in range(Tq)) if causal
            else Tq * Tk)


def flash_attention(B: int, Tq: int, Tk: int, H: int, KV: int, hd: int, *,
                    causal: bool = True, window: int = 0,
                    elem_bytes: int = 2, kind: str = "bf16") -> KernelCost:
    """q, k, v in and o out once; QKᵀ and PV over the scored pairs."""
    q_numel, k_numel = B * Tq * H * hd, B * Tk * KV * hd
    nbytes = elem_bytes * (2 * q_numel + 2 * k_numel)
    pairs = attention_pairs(Tq, Tk, causal, window)
    return KernelCost(4.0 * hd * B * H * pairs, nbytes, kind)


def flash_attention_bwd(B: int, Tq: int, Tk: int, H: int, KV: int, hd: int,
                        *, causal: bool = True, window: int = 0,
                        elem_bytes: int = 2, kind: str = "bf16"
                        ) -> KernelCost:
    """q, dO, k, v and the LSE in, dQ, dK, dV out; S, dP, dQ, dK and dV
    over the scored pairs (five products of the forward's size)."""
    q_numel, k_numel = B * Tq * H * hd, B * Tk * KV * hd
    nbytes = elem_bytes * 3 * q_numel + elem_bytes * 4 * k_numel \
        + 4 * B * H * Tq
    pairs = attention_pairs(Tq, Tk, causal, window)
    return KernelCost(10.0 * hd * B * H * pairs, nbytes, kind)


def quant_matmul(M: int, K: int, N: int, code_bytes: int,
                 x_bytes: int = 2) -> KernelCost:
    """X, the packed codes and the (N,) scale and zero-point in, Y (f32)
    out; 2·M·K·N at the bf16 tensor cores' peak (codes are exact in
    bf16)."""
    nbytes = x_bytes * M * K + code_bytes + 8 * N + 4 * M * N
    return KernelCost(2.0 * M * K * N, nbytes, "bf16")


def live_extent(lengths: Sequence[int], window: int, bs: int):
    """(live pages, live keys) that attention over these lengths needs:
    keys in [max(0, len - window), len), pages that hold them."""
    pages = keys = 0
    for n in lengths:
        if n <= 0:
            continue
        lo = max(0, n - window) if window > 0 else 0
        keys += n - lo
        pages += -(-n // bs) - lo // bs
    return pages, keys


def paged_attention(B: int, H: int, KV: int, hd: int, block_size: int,
                    row_bytes: int, max_blocks: int, pages: int, keys: int,
                    *, q_bytes: int = 2, kv_bits: int = 0) -> KernelCost:
    """One decode token a slot: the live pages' K and V rows (`row_bytes`
    a (token, kv head) row as stored) and, for codes, their (page, kv
    head) scales; q in and o out; the block table and lengths. QKᵀ and PV
    over the live keys, at int8's peak for codes."""
    page_bytes = block_size * KV * row_bytes
    nbytes = (2 * pages * page_bytes + 2 * (B * H * hd) * q_bytes
              + B * max_blocks * 4 + B * 4)
    if kv_bits:
        nbytes += 2 * pages * KV * 4
    return KernelCost(4.0 * H * hd * keys, nbytes,
                      "int8" if kv_bits else "bf16")


def adamw_update(n: int, moment_dtype: str,
                 n_codes: Optional[int] = None) -> KernelCost:
    """One leaf's fused AdamW update, n parameters: p and g (f32) in, p
    out; f32 moments m and v in and out (28 bytes a parameter), or int8
    codes on `n_codes` padded entries (n by default): the first moment's
    int8 codes, 2-bit EF codes and a block scale a 256, the second's uint8
    codes and scale, in and out (~16.6 bytes a parameter); lr, the bias
    corrections and the clip factor in. 17 f32 operations a parameter,
    ~41 with the codec's decode and encode."""
    scalars = 4 * 4
    if moment_dtype != "int8":
        return KernelCost(17.0 * n, 28.0 * n + scalars, "f32")
    c = n if n_codes is None else n_codes
    moments = 2 * (c + c / 4 + 4 * c / 256 + c + 4 * c / 256)
    return KernelCost(41.0 * n, 12.0 * n + moments + scalars, "f32")


def ssm_scan(B: int, T: int, d_inner: int, n: int, dt_rank: int,
             param_numel: int) -> KernelCost:
    """The one-pass selective scan (plain PyTorch, no kernel): x (bf16) in,
    y (f32) and the state out once, the x / dt / B / C projections and
    ~7 f32 operations a (token, channel, state) element."""
    nbytes = (2 * B * T * d_inner + 4 * B * T * d_inner
              + 2 * 4 * B * d_inner * n + 4 * param_numel)
    flops = (2.0 * B * T * d_inner * (dt_rank + 2 * n)
             + 2.0 * B * T * dt_rank * d_inner + 7.0 * B * T * d_inner * n)
    return KernelCost(flops, nbytes, "f32")


def wkv(B: int, T: int, H: int, hd: int, d: int) -> KernelCost:
    """The one-pass wkv recurrence (plain PyTorch, no kernel): r, k, v,
    log w in and the output out (f32), the state in and out, and ~5 f32
    operations a (token, head, k, v) element."""
    nbytes = 4 * (5 * B * T * d + 2 * B * H * hd * hd + H * hd)
    return KernelCost(5.0 * B * T * H * hd * hd, nbytes, "f32")


# ---------------------------------------------------------------------------
# the kernels, by their wrappers' operands (what `kernels/ops.py` charges)
# ---------------------------------------------------------------------------

def comq_panel_of(h_bb: Tensor, s0: Tensor, qf: Tensor, *_) -> KernelCost:
    E = qf.shape[0] if qf.dim() == 3 else 1
    return comq_panel(qf.shape[-2], qf.shape[-1], E)


def flash_attention_of(q: Tensor, k: Tensor, *, causal: bool = True,
                       window: int = 0) -> KernelCost:
    B, Tq, H, hd = q.shape
    return flash_attention(B, Tq, k.shape[1], H, k.shape[2], hd,
                           causal=causal, window=window,
                           elem_bytes=q.element_size(), kind=_kind(q.dtype))


def flash_attention_bwd_of(q: Tensor, k: Tensor, *, causal: bool = True,
                           window: int = 0) -> KernelCost:
    B, Tq, H, hd = q.shape
    return flash_attention_bwd(B, Tq, k.shape[1], H, k.shape[2], hd,
                               causal=causal, window=window,
                               elem_bytes=q.element_size(),
                               kind=_kind(q.dtype))


def quant_matmul_of(x: Tensor, codes: Tensor, *, cpb: int) -> KernelCost:
    M, K = x.shape
    return quant_matmul(M, K, codes.shape[1] * cpb,
                        codes.numel() * codes.element_size(),
                        x.element_size())


def adamw_update_of(p: Tensor, m) -> KernelCost:
    """The update of leaf `p` whose first moment is `m` (an f32 tensor,
    or an int8 codec dict whose codes give the padded count)."""
    if isinstance(m, dict):
        return adamw_update(p.numel(), "int8", m["q"].numel())
    return adamw_update(p.numel(), "float32")


def paged_attention_of(q: Tensor, k_pool: Tensor, block_tables: Tensor,
                       lengths: Tensor, *, window: int = 0,
                       kv_bits: int = 0) -> KernelCost:
    """Reads `lengths` on the host (a sync; the wrappers charge only under
    a running count). Meta lengths hold no values: every table entry is
    then taken as live."""
    B, H, hd = q.shape
    _, BS, KV, row = k_pool.shape
    maxb = block_tables.shape[1]
    if lengths.device.type == "meta":
        pages, keys = B * maxb, B * maxb * BS
    else:
        pages, keys = live_extent(lengths.tolist(), window, BS)
    return paged_attention(B, H, KV, hd, BS, row * k_pool.element_size(),
                           maxb, pages, keys,
                           q_bytes=q.element_size(), kv_bits=kv_bits)
