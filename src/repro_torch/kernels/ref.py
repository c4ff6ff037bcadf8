"""Plain-torch oracles (ports of `repro.kernels.ref`): `quant_matmul_ref`,
the arithmetic of `quant_matmul`'s plain version, and
`paged_attention_ref` / `paged_attention_quant_ref`, the plain versions of
the two paged-attention kernels. (The plain flash attention is the port of
`ref.flash_attention_ref` in the model's layout:
`kernels/flash_attention.flash_attention_plain`; the plain panel sweep is
`core/comq_hessian.panel_sweep_dq_ref`.)"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def quant_matmul_ref(x: Tensor, codes_u: Tensor, scale: Tensor, z_lo: Tensor,
                     out_dtype=torch.float32) -> Tensor:
    """x: (M, K); codes_u: (K, N) uint8 offset-binary; scale/z_lo: (N,).

    Y = X · W_q,  W_q[k, n] = scale[n] · (codes_u[k, n] + z_lo[n])."""
    w = (codes_u.float() + z_lo.float()) * scale
    return (x.float() @ w).to(out_dtype)



def paged_attention_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                        block_tables: Tensor, lengths: Tensor, *,
                        window: int = 0, head_map=None) -> Tensor:
    """q: (B, H, hd); k_pool/v_pool: (NB, BS, KV, hd); block_tables:
    (B, MAXB); lengths: (B,). Gather the slot's pages into a contiguous
    (B, MAXB·BS, KV, hd) view, then masked softmax attention in f32 (the
    query sits at position length-1). Inactive slots (length 0) return
    exact zeros. Query head h reads KV head h // (H // KV), or
    head_map[h] (a host tuple; the gathered K/V expanded by index).
    Returns f32."""
    from repro_torch.kernels import headmap
    head_map = headmap.normalize(head_map, q.shape[1], k_pool.shape[2])
    B, H, hd = q.shape
    NB, BS, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    S = block_tables.shape[1] * BS
    idx = (block_tables.long()[:, :, None] * BS
           + torch.arange(BS, device=q.device)[None, None]).reshape(B, S)
    kg = k_pool.reshape(NB * BS, KV, hd)[idx].float()
    vg = v_pool.reshape(NB * BS, KV, hd)[idx].float()
    if head_map is not None:     # one group of one head a query head
        hidx = headmap.index(head_map, q.device)
        kg, vg, KV = kg[:, :, hidx], vg[:, :, hidx], H
    g = H // KV
    qg = q.float().reshape(B, KV, g, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    s = torch.einsum("bkgh,bskh->bkgs", qg, kg) * scale
    kpos = torch.arange(S, device=q.device)[None]
    lens = lengths.long()[:, None]
    mask = kpos < lens
    if window > 0:
        mask = mask & ((lens - 1) - kpos < window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where((lengths > 0)[:, None, None, None], p,
                    torch.zeros_like(p))
    return torch.einsum("bkgs,bskh->bkgh", p, vg).reshape(B, H, hd)


def paged_attention_quant_ref(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                              k_scale: Tensor, v_scale: Tensor,
                              block_tables: Tensor, lengths: Tensor, *,
                              window: int = 0, kv_bits: int = 8,
                              head_map=None) -> Tensor:
    """Quantized-pool oracle: k_pool/v_pool hold integer codes
    (NB, BS, KV, hd/cpb — int8, or packed 4-bit nibble pairs) with one f32
    scale per (page, kv_head) in k_scale/v_scale (NB, KV). Dequantizes
    page-wise in f32 with `serve.kv_cache.kv_decode` and delegates to
    `paged_attention_ref`."""
    from repro_torch.serve.kv_cache import kv_decode
    kd = kv_decode(k_pool, k_scale[:, None], kv_bits)   # (NB, BS, KV, hd)
    vd = kv_decode(v_pool, v_scale[:, None], kv_bits)
    return paged_attention_ref(q, kd, vd, block_tables, lengths,
                               window=window, head_map=head_map)
