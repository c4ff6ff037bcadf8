"""`paged_attention` and `paged_attention_quant`: decode attention of one
query token per slot over a paged KV pool — Hopper kernels
(csrc/paged_attention.cu) and their plain versions.

Replace the Pallas TPU kernels `src/repro/kernels/paged_attention.py`
(`paged_attention_pallas`, and `paged_attention_quant_pallas` with its
body `_quant_kernel`). Both read the serving layout of
`serve/kv_cache.py`: q (B, H, hd); pool (NB, BS, KV, hd) in f32/bf16, or
(NB, BS, KV, hd/cpb) int8 codes / 4-bit nibble pairs with (NB, KV) f32
page scales; block tables (B, MAXB) int32; lengths (B,) int32, 0 =
inactive (exact zeros). The query sits at position length-1; `window` > 0
also masks keys with (length-1) - pos >= window. Output (B, H, hd) in
q.dtype (f32 or bf16). Query head h reads KV head h // (H // KV), or
head_map[h] under a `head_map` (a host tuple, `kernels/headmap.py`): a
split block then takes its KV head's group from the map's device table,
at most 16 heads, and the workspaces are sized by the largest group.

What bounds them is the bytes of the live pages; the source notes the
design (flash-decoding: fixed 256-token splits per (slot, kv head) and a
combine pass, so a slot's result does not depend on its batchmates).
Dispatch by dtype and shape only (never by a failure):
- bf16 q over bf16 pages: the tensor-core split kernel (mma.sync bf16
  with f32 accumulation, pages gathered through a 3-stage cp.async ring;
  needs an even hd and pages of at most 512 tokens, else it raises);
- bf16 q over int8 codes with hd % 4 == 0, or over 4-bit codes with
  hd % 8 == 0 (rows copied in 4-byte cp.async units), with splits of at
  most 512 tokens: the tensor-core split kernel for codes, which copies
  the raw codes and widens them to bf16 in registers (`quant_kernel`);
- everything else (f32 q or pages, quantized rows narrower than that):
  the CUDA-core split kernel (f32 math).

Tolerance against the plain version (which dequantizes in f32 and runs
the f32 oracle): the same f32 softmax summed in another order, so
|Δ| ≤ 8e-3·|want| + 1e-3 in bf16 (two bf16 ulps) and |Δ| ≤ 1e-4 in f32;
zero-length slots are exactly 0 in both. On the tensor cores the codes
are exact in bf16, S is the f32-accumulated product of bf16 q and the
codes, and P·vs enters P·V as bf16 hi + lo (~16 bits).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import headmap as _hm

Tensor = torch.Tensor
NAME = "paged_attention"
NAME_QUANT = "paged_attention_quant"
launches = 0          # paged_attention launches since the last reset
launches_quant = 0    # paged_attention_quant launches since the last reset
launches_quant_tc = 0  # ... of them on the tensor-core kernel
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"

_SPLIT_TOKENS = 256   # keys per split (csrc: one block per split)
_MAX_G, _MAX_HD = 16, 256
_MAX_SPAN = 512       # tensor-core kernels: a split of at most 512 tokens
_PAGE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_QUANT = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])


def paged_attention_plain(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                          block_tables: Tensor, lengths: Tensor, *,
                          window: int = 0, head_map=None) -> Tensor:
    """`ref.paged_attention_ref` in q.dtype."""
    return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   window=window,
                                   head_map=head_map).to(q.dtype)


def paged_attention_quant_plain(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                                k_scale: Tensor, v_scale: Tensor,
                                block_tables: Tensor, lengths: Tensor, *,
                                window: int = 0, kv_bits: int = 8,
                                head_map=None) -> Tensor:
    """`ref.paged_attention_quant_ref` (f32 dequantization) in q.dtype."""
    return ref.paged_attention_quant_ref(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
        window=window, kv_bits=kv_bits, head_map=head_map).to(q.dtype)


def _pages_per_split(block_size: int) -> int:
    return max(1, _SPLIT_TOKENS // block_size)


def quant_kernel(q_dtype: torch.dtype, kv_bits: int, hd: int,
                 block_size: int) -> str:
    """The kernel `paged_attention_quant_cuda` launches, by dtype and shape
    only: TENSOR_CORE for bf16 q over int8 codes with hd % 4 == 0 or 4-bit
    codes with hd % 8 == 0 (rows in 4-byte cp.async units) and splits of
    pps·BS ≤ 512 tokens; CUDA_CORE otherwise (f32 q, narrower rows)."""
    row_unit = 4 if kv_bits == 8 else 8
    if (q_dtype == torch.bfloat16 and hd % row_unit == 0
            and _pages_per_split(block_size) * block_size <= _MAX_SPAN):
        return TENSOR_CORE
    return CUDA_CORE


def _check(name: str, q: Tensor, k_pool: Tensor, v_pool: Tensor,
           block_tables: Tensor, lengths: Tensor, row: int, head_map=None):
    """Validate the common operands (`head_map` normalized: None for the
    even map); returns (B, H, KV, hd, NB, BS, MAXB, G), G the largest
    group."""
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} kernel needs CUDA tensors, got {dev}")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: want q (B,H,hd) and pools (NB,BS,KV,row); "
                         f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, H, hd = q.shape
    NB, BS, KV = k_pool.shape[:3]
    G = (H // KV if head_map is None
         else _hm.max_group(head_map, H, KV))
    if (k_pool.shape[3] != row or (head_map is None and H % KV)
            or G > _MAX_G or hd > _MAX_HD):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} pool "
                         f"{tuple(k_pool.shape)} (needs row {row}, "
                         f"H % KV == 0 or a head map, at most {_MAX_G} "
                         f"query heads a KV head, hd <= {_MAX_HD})")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: want block_tables (B, MAXB) and lengths "
                         f"(B,), got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    for t, what in ((block_tables, "block_tables"), (lengths, "lengths")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    for t in (q, k_pool, v_pool, block_tables, lengths):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous on "
                             f"{dev}")
    return B, H, KV, hd, NB, BS, block_tables.shape[1], G


def _launch(lib_fn: str, q: Tensor, k_pool: Tensor, v_pool: Tensor,
            scales, block_tables: Tensor, lengths: Tensor, kind: int,
            dims, window: int, argtypes, route=(), head_map=None) -> Tensor:
    B, H, KV, hd, NB, BS, MAXB, G = dims
    pps = _pages_per_split(BS)
    ns = max(1, -(-MAXB // pps))
    dev = q.device
    o = torch.empty(B, H, hd, dtype=q.dtype, device=dev)
    part_acc = torch.empty(B, KV, ns, G, hd, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(B, KV, ns, G, 2, dtype=torch.float32, device=dev)
    shape = (ctypes.c_int * 11)(B, H, KV, hd, NB, BS, MAXB, pps, ns,
                                int(window), G)
    table = None if head_map is None else _hm.table(head_map, KV, dev)
    fn = build.load(NAME, lib_fn, argtypes)
    ptrs = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr()]
    ptrs += [s.data_ptr() for s in scales]
    ptrs += [block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(),
             None if table is None else table.data_ptr()]
    rc = fn(*ptrs, _Q_DTYPES[q.dtype], kind, *route,
            ctypes.addressof(shape), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    return o


def _normal_map(head_map, q: Tensor, k_pool: Tensor):
    if q.dim() != 3 or k_pool.dim() != 4:
        return head_map      # _check refuses the shapes
    return _hm.normalize(head_map, q.shape[1], k_pool.shape[2])


def paged_attention_cuda(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                         block_tables: Tensor, lengths: Tensor, *,
                         window: int = 0, head_map=None) -> Tensor:
    """Launch the kernel over an f32 or bf16 page pool."""
    global launches
    head_map = _normal_map(head_map, q, k_pool)
    dims = _check(NAME, q, k_pool, v_pool, block_tables, lengths,
                  row=q.shape[-1] if q.dim() == 3 else -1,
                  head_map=head_map)
    if k_pool.dtype not in _PAGE_KIND or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{NAME}: pages must be f32 or bf16, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if q.dtype == k_pool.dtype == torch.bfloat16 and (dims[3] % 2
                                                      or dims[5] > _MAX_SPAN):
        raise ValueError(f"{NAME}: the bf16 kernel copies rows in 4-byte "
                         f"units and takes pages of at most {_MAX_SPAN} "
                         f"tokens: needs an even hd, got hd {dims[3]}, BS "
                         f"{dims[5]}")
    o = _launch(NAME, q, k_pool, v_pool, (), block_tables, lengths,
                _PAGE_KIND[k_pool.dtype], dims, window, _ARGTYPES,
                head_map=head_map)
    launches += 1
    return o


def paged_attention_quant_cuda(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                               k_scale: Tensor, v_scale: Tensor,
                               block_tables: Tensor, lengths: Tensor, *,
                               window: int = 0, kv_bits: int = 8,
                               head_map=None) -> Tensor:
    """Launch the kernel over int8 (kv_bits 8) or 4-bit nibble-pair
    (kv_bits 4) codes with (NB, KV) f32 page scales: the tensor-core or
    the CUDA-core split kernel, as `quant_kernel` says."""
    global launches_quant, launches_quant_tc
    head_map = _normal_map(head_map, q, k_pool)
    if kv_bits not in (4, 8):
        raise ValueError(f"{NAME_QUANT}: kv_bits must be 4 or 8, got "
                         f"{kv_bits}")
    hd = q.shape[-1] if q.dim() == 3 else -1
    dims = _check(NAME_QUANT, q, k_pool, v_pool, block_tables, lengths,
                  row=hd if kv_bits == 8 else hd // 2, head_map=head_map)
    want = torch.int8 if kv_bits == 8 else torch.uint8
    if k_pool.dtype != want or v_pool.dtype != want or (kv_bits == 4
                                                        and hd % 2):
        raise TypeError(f"{NAME_QUANT}: kv_bits={kv_bits} pages must be "
                        f"{want} (even hd for 4-bit), got {k_pool.dtype}")
    NB, KV = dims[4], dims[2]
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or tuple(s.shape) != (NB, KV) \
                or s.device != q.device or not s.is_contiguous():
            raise ValueError(f"{NAME_QUANT}: scales must be contiguous f32 "
                             f"({NB}, {KV}) on {q.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    tc = quant_kernel(q.dtype, kv_bits, dims[3], dims[5]) == TENSOR_CORE
    o = _launch(NAME_QUANT, q, k_pool, v_pool, (k_scale, v_scale),
                block_tables, lengths, 2 if kv_bits == 8 else 3, dims,
                window, _ARGTYPES_QUANT, route=(int(tc),),
                head_map=head_map)
    launches_quant += 1
    launches_quant_tc += tc
    return o
