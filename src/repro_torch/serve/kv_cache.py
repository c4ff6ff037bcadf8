"""Paged KV-cache pool: fixed-size pages + per-slot block tables (port of
`repro.serve.kv_cache`).

The pool owns `num_blocks` pages of `block_size` tokens shared by all
slots; a slot maps logical block i -> physical page through its
block-table row, pages are allocated at admission and freed at
completion, and decode attention walks the table (kernels
`paged_attention[_quant]`). Memory scales with the live tokens, not
max_slots x max_len.

Device layout (models/model.decode_step_paged walks the layers):

    pool["k"], pool["v"]: (L, num_blocks, block_size, KV, hd)
    block_tables:         (max_slots, max_blocks_per_slot) int32
    pos:                  (max_slots,) absolute next position, -1 inactive

With quantized pages ("k_scale"/"v_scale" present) the pool holds integer
codes (int8, or 4-bit offset-binary nibble pairs, low nibble first) and
one f32 scale per (layer, page, kv_head).

`BlockAllocator` is plain host state. `write_prefill` scatters a
prefilled dense cache's rows into a slot's pages, in place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.quantizer import pack_int4, unpack_int4

Tensor = torch.Tensor


def blocks_for(tokens: int, block_size: int) -> int:
    """Pages needed to hold `tokens` positions."""
    return max(1, math.ceil(tokens / block_size))


# Quantized pages: integer codes + one f32 scale per (layer, page, kv_head).
# int8 is symmetric absmax/127; 4-bit packs two offset-binary nibbles per
# byte (code = q + 8, q in [-7, 7]) with a clip-aware scale shrink.
KV4_CLIP = 0.96


def _kv_qmax(kv_bits: int) -> float:
    return 127.0 if kv_bits == 8 else 7.0


def kv_code_width(kv_bits: int) -> int:
    """Codes per byte of pool storage (1 for int8, 2 for packed 4-bit)."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    return 1 if kv_bits == 8 else 2


def kv_scale_of(absmax: Tensor, kv_bits: int) -> Tensor:
    """Per-(page, kv_head) scale from the page's row absmax."""
    clip = 1.0 if kv_bits == 8 else KV4_CLIP
    return (clip / _kv_qmax(kv_bits)) * absmax.float()


def kv_encode(rows: Tensor, scale: Tensor, kv_bits: int) -> Tensor:
    """rows (..., hd) float -> integer codes under `scale` (broadcast over
    hd). Zero scale (all-zero page) encodes to zero codes exactly."""
    qmax = _kv_qmax(kv_bits)
    s = scale.float()[..., None]
    pos = s > 0
    q = torch.where(pos, rows.float() / torch.where(pos, s, 1.0), 0.0)
    q = torch.clamp(torch.round(q), -qmax, qmax)
    if kv_bits == 8:
        return q.to(torch.int8)
    return pack_int4((q + 8.0).to(torch.uint8))


def kv_decode(codes: Tensor, scale: Tensor, kv_bits: int,
              dtype=torch.float32) -> Tensor:
    """Inverse of kv_encode: codes (..., hd / cpb) -> (..., hd) floats."""
    if kv_bits == 8:
        q = codes.float()
    else:
        q = unpack_int4(codes).float() - 8.0
    return (q * scale.float()[..., None]).to(dtype)


def init_paged_cache(cfg, plan, num_blocks: int, block_size: int,
                     device=None) -> Dict[str, Tensor]:
    """Zeroed K/V page pools with a leading layer dim. With `plan.kv_bits`
    in {4, 8} pages hold integer codes plus per-(layer, page, kv_head)
    f32 scales under "k_scale"/"v_scale"."""
    hd = cfg.resolved_head_dim
    kv_bits = int(getattr(plan, "kv_bits", 0) or 0)
    if not kv_bits:
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=plan.cache_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=plan.cache_dtype,
                                 device=device)}
    cpb = kv_code_width(kv_bits)
    if hd % cpb:
        raise ValueError(f"kv_bits={kv_bits} needs head_dim % {cpb} == 0")
    dt = torch.int8 if kv_bits == 8 else torch.uint8
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, hd // cpb)
    sshape = (cfg.n_layers, num_blocks, cfg.n_kv_heads)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def paged_cache_bytes(cfg, plan, num_blocks: int, block_size: int) -> int:
    """Device bytes the pool holds: code (or bf16) payload plus, when
    quantized, the per-(layer, page, kv_head) f32 scale tensors."""
    hd = cfg.resolved_head_dim
    kv_bits = int(getattr(plan, "kv_bits", 0) or 0)
    if not kv_bits:
        itemsize = torch.empty((), dtype=plan.cache_dtype).element_size()
        return 2 * cfg.n_layers * num_blocks * block_size * cfg.n_kv_heads \
            * hd * itemsize
    payload = 2 * cfg.n_layers * num_blocks * block_size * cfg.n_kv_heads \
        * (hd // kv_code_width(kv_bits))
    scales = 2 * cfg.n_layers * num_blocks * cfg.n_kv_heads * 4
    return payload + scales


class BlockAllocator:
    """Host-side free list over the physical pages. No device state: the
    pool itself never moves — allocation only decides which page ids a
    slot's block-table row points at.

    `fail_hook`, when set and returning True, makes alloc report
    exhaustion even with pages free (drives the backpressure/preemption
    paths deterministically in tests).

    `partitions` > 1 splits the pool into contiguous equal ranges:
    partition p owns pages [p*npp, (p+1)*npp)."""

    def __init__(self, num_blocks: int,
                 fail_hook: Optional[Callable[[], bool]] = None,
                 partitions: int = 1):
        if partitions < 1 or num_blocks % partitions:
            raise ValueError(f"num_blocks={num_blocks} must split evenly "
                             f"over {partitions} partitions")
        self.num_blocks = num_blocks
        self.partitions = partitions
        self.partition_blocks = num_blocks // partitions
        npp = self.partition_blocks
        # LIFO within each partition, matching the single-partition order
        self._frees: List[List[int]] = [
            list(range((p + 1) * npp - 1, p * npp - 1, -1))
            for p in range(partitions)]
        self._held: set = set()
        self.peak_in_use = 0
        self.fail_hook = fail_hook

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._frees)

    def num_free_in(self, part: int) -> int:
        return len(self._frees[part])

    @property
    def in_use(self) -> int:
        return self.num_blocks - self.num_free

    def alloc(self, n: int, part: int = 0) -> Optional[List[int]]:
        """n pages from `part`, or None when the partition is exhausted
        (admission backpressure / preemption trigger) or when the fault
        hook fires."""
        if self.fail_hook is not None and self.fail_hook():
            return None
        free = self._frees[part]
        if n > len(free):
            return None
        out = [free.pop() for _ in range(n)]
        self._held.update(out)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def partition_of(self, block: int) -> int:
        return block // self.partition_blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b < 0 or b >= self.num_blocks:
                raise ValueError(f"freeing unknown block {b}")
            if b not in self._held:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._held.discard(b)
            self._frees[self.partition_of(b)].append(b)

    def check_integrity(self) -> None:
        """Free list and held set must exactly partition the pool — the
        no-leak/no-double-free oracle."""
        free = set()
        for p, fl in enumerate(self._frees):
            if len(set(fl)) != len(fl):
                raise AssertionError("duplicate page ids on the free list")
            for b in fl:
                if self.partition_of(b) != p:
                    raise AssertionError(
                        f"page {b} on partition {p}'s free list")
            free.update(fl)
        if free & self._held:
            raise AssertionError(
                f"pages both free and held: {sorted(free & self._held)}")
        if len(free) + len(self._held) != self.num_blocks:
            missing = set(range(self.num_blocks)) - free - self._held
            raise AssertionError(f"leaked pages: {sorted(missing)}")


def write_prefill(pool: Dict[str, Tensor], k_seq: Tensor, v_seq: Tensor,
                  pos_row: Tensor, table_row: Tensor,
                  kv_bits: int = 0) -> Dict[str, Tensor]:
    """Scatter one request's prefilled K/V rows into its pages, in place
    (the pool tensors are updated and the same dict is returned).

    k_seq/v_seq: (L, S, KV, hd) from the dense prefill cache; pos_row: (S,)
    absolute positions (-1 = unwritten row, dropped); table_row: (MAXB,)
    physical page ids. Rows route by position — block pos//BS, offset
    pos%BS — so ring-buffer (SWA) prefill caches scatter correctly.

    With `kv_bits` set the rows quantize on the way in: every touched page
    gets a fresh scale from a scatter-max of its incoming row absmaxes
    (prefill owns all live rows of its pages, so overwriting the page
    scale is exact and also wipes any stale scale left by a freed
    request), then rows encode at their page's scale and the codes
    scatter. Untouched pages keep code and scale bits untouched.

    Every shape is fixed and nothing is read on the host, so the write is
    one CUDA graph a cache length. JAX drops a row by an out-of-range
    index; here every one of the S rows writes, and a dropped row carries
    the first kept row's bytes to that row's place (so it touches no other
    page, and adds nothing to a page's absmax that the kept row does not).
    With no kept row, every row writes back what its place already holds.
    Duplicate writes of the same bytes make the result the same whatever
    order they land in."""
    k_pool, v_pool = pool["k"], pool["v"]
    L, NB, BS = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    S = pos_row.shape[0]
    valid = pos_row >= 0
    any_valid = valid.any()
    # each row's source: itself if kept, else the first kept row (argmax
    # returns the first maximum; row 0 when none is kept)
    first = torch.argmax(valid.to(torch.uint8))
    src = torch.where(valid, torch.arange(S, device=pos_row.device), first)
    pos = pos_row.long()[src].clamp_min(0)
    phys = table_row.long()[pos // BS]
    dest = phys * BS + pos % BS
    if not kv_bits:
        for cpool, seq in ((k_pool, k_seq), (v_pool, v_seq)):
            flat = cpool.view(L, NB * BS, *cpool.shape[3:])
            rows = torch.where(any_valid, seq[:, src].to(cpool.dtype),
                               flat[:, dest])
            flat[:, dest] = rows
        return pool

    touched = torch.zeros(NB, dtype=torch.bool, device=k_pool.device)
    touched[phys] = any_valid
    for name, cpool, seq in (("k", k_pool, k_seq), ("v", v_pool, v_seq)):
        KV = cpool.shape[3]
        r = seq[:, src].float()                                 # (L, S, KV, hd)
        absmax = r.abs().amax(dim=-1)                           # (L, S, KV)
        pmax = torch.zeros(L, NB, KV, dtype=torch.float32,
                           device=cpool.device)
        idx = phys[None, :, None].expand(L, -1, KV)
        pmax.scatter_reduce_(1, idx, absmax, reduce="amax")
        scale = pool[name + "_scale"]
        new_scale = torch.where(touched[None, :, None],
                                kv_scale_of(pmax, kv_bits), scale)
        flat = cpool.view(L, NB * BS, *cpool.shape[3:])
        codes = torch.where(any_valid,
                            kv_encode(r, new_scale[:, phys], kv_bits),
                            flat[:, dest])
        flat[:, dest] = codes
        scale.copy_(new_scale)
    return pool
