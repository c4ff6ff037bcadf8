"""The arithmetic of the tensor-core attention kernels, emulated in plain
torch on the CPU and held against the plain versions.

`csrc/flash_attention.cu` and `csrc/paged_attention.cu` (bf16 paths)
compute S = Q·Kᵀ from bf16 operands with f32 accumulation (mma.sync), run
the online softmax in f32 over 64-key tiles in log2 units, and feed P to
P·V as two bf16 operands, hi = bf16(p) and lo = bf16(p − hi). The paged
kernel also splits each slot into fixed 256-token splits, gives each of 4
warps 16 keys of a tile with its own (m, l, acc), merges the warps at the
end of the split and combines the splits. These emulations repeat that
order of operations and must hold the kernels' unchanged bf16 tolerance,
|Δ| ≤ 8e-3·|want| + 1e-3, at qwen2's head layout (28 query / 4 KV heads,
head_dim 128). The same with P in bf16 only is printed, not asserted: it
is the design split-P replaces.

The paged kernel for bf16 q over int8 / 4-bit codes widens the codes to
bf16 by magic numbers (int8: the f32 with bits 0x4B0000uu, u = c ^ 0x80,
less 2^23 + 128, then its top 16 bits; 4-bit: the bf16 0x4300 | u less
136), multiplies each key's score by scale·log2e·ks after the mma, sums l
from the unscaled P and feeds P·vs to P·V as bf16 hi + lo.
`paged_quant_emulated` follows that arithmetic and is held against the
plain version and the JAX oracle; the widening is checked on every code.
The rule that picks that kernel (`quant_kernel`) is checked here too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.quantizer import unpack_int4
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.serve.kv_cache import kv_encode, kv_scale_of

torch.set_num_threads(2)

TILE, WARPS, SPLIT = 64, 4, 256       # keys a tile, warps, tokens a split
LOG2E = 1.4426950408889634
RTOL, ATOL = 8e-3, 1e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _pv(p, v, split_p):
    """P·V in f32 with P as bf16 hi (+ lo)."""
    hi = _bf16(p)
    out = hi @ v
    return out + _bf16(p - hi) @ v if split_p else out


def _online_step(s, v, m, l, acc, split_p, vs=None):
    """One online-softmax step over scores s (..., rows, keys) in log2
    units, -inf where masked; returns the new (m, l, acc). With `vs` (per
    key), l sums the unscaled P and P·V sees P·vs."""
    mx = torch.maximum(m, s.amax(-1))
    base = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
    corr = torch.exp2(m - base)
    p = torch.exp2(s - base[..., None])
    pv = p if vs is None else p * vs
    return mx, l * corr + p.sum(-1), acc * corr[..., None] + _pv(pv, v,
                                                                 split_p)


def flash_emulated(q, k, v, *, window=0, split_p=True):
    """q (B, T, H, hd), k/v (B, T, KV, hd) bf16, causal -> bf16."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
              for t in (k, v))
    scale = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=torch.float32)
    m = torch.full((B, H, T), -math.inf)
    l, acc = torch.zeros(B, H, T), torch.zeros(B, H, T, hd)
    qpos = torch.arange(T)[:, None]
    for kt in range(0, T, TILE):
        kpos = torch.arange(kt, min(kt + TILE, T))[None, :]
        s = (qf @ kf[:, :, kt:kt + TILE].transpose(-1, -2)) * scale
        live = kpos <= qpos
        if window > 0:
            live = live & (qpos - kpos < window)
        s = s.masked_fill(~live, -math.inf)
        m, l, acc = _online_step(s, vf[:, :, kt:kt + TILE], m, l, acc,
                                 split_p)
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _split_attend(qb, kf, vf, ks, vs, n, window, split_p):
    """One slot of the paged tensor-core kernels: qb (H, 1, hd) f32 (bf16
    values); kf / vf (H, n, hd) f32 keys and values (exact in bf16); ks
    the factor on S (the softmax scale in log2 units; (H, 1, n) per key
    for codes), vs None or the (H, 1, n) per-key factor on P before P·V. 256-token splits, 64-key
    tiles, 16 keys a warp, merged per split, combined. -> (H, hd) f32."""
    H, hd = qb.shape[0], qb.shape[-1]
    k_lo = max(0, n - window) if window > 0 else 0
    parts = []                                             # (m_nat, l, acc)
    for s_lo in range(0, n, SPLIT):
        lo, hi = max(k_lo, s_lo), min(n, s_lo + SPLIT)
        if lo >= hi:
            continue
        warps = [(torch.full((H, 1), -math.inf), torch.zeros(H, 1),
                  torch.zeros(H, 1, hd)) for _ in range(WARPS)]
        for t0 in range(lo, hi, TILE):
            for w in range(WARPS):
                a, z = t0 + 16 * w, min(t0 + 16 * w + 16, hi)
                if a >= z:
                    continue
                kscale = ks if ks.dim() == 0 else ks[..., a:z]
                s = (qb @ kf[:, a:z].transpose(-1, -2)) * kscale
                warps[w] = _online_step(s, vf[:, a:z], *warps[w], split_p,
                                        None if vs is None else vs[..., a:z])
        mx = torch.stack([w[0] for w in warps]).amax(0)
        wgt = [torch.exp2(w[0] - mx) for w in warps]
        parts.append((mx * math.log(2.0),
                      sum(g * w[1] for g, w in zip(wgt, warps)),
                      sum(g[..., None] * w[2] for g, w in zip(wgt, warps))))
    big_m = torch.stack([p[0] for p in parts]).amax(0)
    total_l, total = torch.zeros(H, 1), torch.zeros(H, 1, hd)
    for m, l, acc in parts:
        wgt = torch.exp(m - big_m)
        total_l = total_l + wgt * l
        total = total + wgt[..., None] * acc
    return (total / total_l.clamp_min(1e-20)[..., None])[:, 0]


def _slot_rows(pool, bt_row, n, G):
    """The slot's n key rows of a (NB, BS, KV, hd) pool as (H, n, hd)."""
    BS, KV, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    pos = torch.arange(n)
    rows = bt_row[pos // BS].long() * BS + pos % BS
    return (pool.reshape(-1, KV, hd)[rows].float().permute(1, 0, 2)
            .repeat_interleave(G, 0))


def paged_emulated(q, k_pool, v_pool, bt, lens, *, window=0, split_p=True):
    """q (B, H, hd) bf16 over bf16 pages (NB, BS, KV, hd) -> bf16."""
    B, H, hd = q.shape
    G = H // k_pool.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=torch.float32)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        out[b] = _split_attend(q[b].float()[:, None, :],
                               _slot_rows(k_pool, bt[b], n, G),
                               _slot_rows(v_pool, bt[b], n, G), scale, None,
                               n, window, split_p)
    return out.to(torch.bfloat16)


def widen_int8(codes):
    """int8 codes -> bf16 through the kernel's bit pattern: u = c ^ 0x80 in
    the f32 0x4B0000uu, less 2^23 + 128, top 16 bits."""
    u = codes.view(torch.uint8).to(torch.int32) ^ 0x80
    f = (u | 0x4B000000).view(torch.float32) - 8388736.0
    return (f.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def widen_int4(nibbles):
    """4-bit offset-binary u (0..15, any int dtype) -> bf16: the bf16
    0x4300 | u, less 136 in bf16 (the kernel's __hsub2)."""
    x = (nibbles.to(torch.int32) | 0x4300).to(torch.int16).view(
        torch.bfloat16)
    return (x.float() - 136.0).to(torch.bfloat16)


def paged_quant_emulated(q, k_pool, v_pool, k_scale, v_scale, bt, lens, *,
                         window=0, kv_bits=8):
    """q (B, H, hd) bf16 over int8 / 4-bit code pools (NB, BS, KV, row)
    with (NB, KV) f32 page scales, as the tensor-core kernel computes it:
    codes widened to bf16 exactly, S = bf16 q · codes accumulated in f32,
    times the per-key f32 factor scale·log2e·ks, l from the unscaled P,
    P·vs split into bf16 hi + lo. -> bf16."""
    B, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    widen = (widen_int8 if kv_bits == 8
             else lambda c: widen_int4(unpack_int4(c)))
    kw, vw = widen(k_pool), widen(v_pool)                 # (NB, BS, KV, hd)
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        pages = bt[b, torch.arange(n) // BS].long()
        ks = (scale_log2 * k_scale[pages].float()).repeat_interleave(G, 1)
        vs = v_scale[pages].float().repeat_interleave(G, 1)   # (n, H)
        out[b] = _split_attend(q[b].float()[:, None, :],
                               _slot_rows(kw, bt[b], n, G),
                               _slot_rows(vw, bt[b], n, G),
                               ks.T[:, None, :], vs.T[:, None, :], n, window,
                               True)
    return out.to(torch.bfloat16)


def _gap(got, want):
    """(max |Δ|, whether every element is within the bf16 tolerance)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= RTOL * want.float().abs()
                                 + ATOL).all())


def _report(name, got, got_bf16_p, want):
    err, ok = _gap(got, want)
    err_b, ok_b = _gap(got_bf16_p, want)
    print(f"{name}: split-P max|d| {err:.3e} (within tolerance: {ok}); "
          f"P in bf16 only max|d| {err_b:.3e} (within tolerance: {ok_b})")
    return ok


@pytest.mark.parametrize("B,T,window", [(1, 512, 0), (2, 128, 0),
                                        (1, 300, 100)],
                         ids=["serve-prefill", "decode-batch", "window"])
def test_flash_split_p_design_holds_the_bf16_tolerance(B, T, window):
    H, KV, hd = 28, 4, 128
    rng = np.random.default_rng(T + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, n, hd))
                                .astype(np.float32)).bfloat16()
               for n in (H, KV, KV))
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    got = flash_emulated(q, k, v, window=window)
    only_hi = flash_emulated(q, k, v, window=window, split_p=False)
    assert _report(f"flash B={B} T={T} window={window}", got, only_hi, want)


@pytest.mark.parametrize("window", [0, 1024])
def test_paged_split_p_design_holds_the_bf16_tolerance(window):
    H, KV, hd, BS = 28, 4, 128, 16
    lens_l = [1, 255, 256, 257, 1000, 2048, 0]
    maxb = 2048 // BS
    rng = np.random.default_rng(window + 7)
    B, NB = len(lens_l), len(lens_l) * maxb
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).bfloat16()
    k_pool, v_pool = (torch.from_numpy(rng.standard_normal(
        (NB, BS, KV, hd)).astype(np.float32)).bfloat16() for _ in range(2))
    bt = torch.from_numpy(rng.permutation(NB).reshape(B, maxb).astype(
        np.int32))
    lens = torch.tensor(lens_l, dtype=torch.int32)
    want = paged_attention_plain(q, k_pool, v_pool, bt, lens, window=window)
    got = paged_emulated(q, k_pool, v_pool, bt, lens, window=window)
    only_hi = paged_emulated(q, k_pool, v_pool, bt, lens, window=window,
                             split_p=False)
    assert bool((got[lens == 0] == 0).all())
    assert _report(f"paged window={window}", got, only_hi, want)


def _quant_inputs(kv_bits, seed):
    """bf16 q and int8 / 4-bit pools (codes and (NB, KV) scales from the
    port's encoder) at qwen2's head layout, 16-token pages, the lengths of
    the split and tile edges."""
    H, KV, hd, BS = 28, 4, 128, 16
    lens_l = [0, 1, 255, 256, 257, 1000, 2048]
    maxb = 2048 // BS
    rng = np.random.default_rng(seed)
    B, NB = len(lens_l), len(lens_l) * maxb
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).bfloat16()
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((NB, BS, KV, hd)).astype(
            np.float32))
        scale = kv_scale_of(x.abs().amax(dim=(1, 3)), kv_bits)    # (NB, KV)
        pools += [kv_encode(x, scale[:, None], kv_bits), scale]
    bt = torch.from_numpy(rng.permutation(NB).reshape(B, maxb).astype(
        np.int32))
    kq, ks, vq, vs = pools
    return q, kq, vq, ks, vs, bt, torch.tensor(lens_l, dtype=torch.int32)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("window", [0, 1024])
def test_paged_quant_tensor_core_arithmetic_holds_the_bf16_tolerance(
        kv_bits, window):
    q, kq, vq, ks, vs, bt, lens = _quant_inputs(kv_bits, kv_bits + window)
    got = paged_quant_emulated(q, kq, vq, ks, vs, bt, lens, window=window,
                               kv_bits=kv_bits)
    plain = pa.paged_attention_quant_plain(q, kq, vq, ks, vs, bt, lens,
                                           window=window, kv_bits=kv_bits)
    oracle = torch.from_numpy(np.array(jref.paged_attention_quant_ref(
        *(jnp.asarray(t.numpy()) for t in (q.float(), kq, vq, ks, vs, bt,
                                           lens)),
        window=window, kv_bits=kv_bits)))
    assert got.dtype == torch.bfloat16
    assert bool((got[lens == 0] == 0).all())
    for name, want in (("plain", plain), ("JAX oracle", oracle)):
        err, ok = _gap(got, want)
        print(f"paged quant kv_bits={kv_bits} window={window} vs {name}: "
              f"max|d| {err:.3e}")
        assert ok, (name, err)


def test_code_widening_is_exact_for_every_code():
    codes = torch.arange(-128, 128, dtype=torch.int32)
    got = widen_int8(codes.to(torch.int8))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), codes.float())
    nibbles = torch.arange(16, dtype=torch.uint8)
    assert torch.equal(widen_int4(nibbles).float(), nibbles.float() - 8.0)
    # the packed byte layout: low nibble first, offset binary
    vals = torch.tensor([*range(-7, 8), 0], dtype=torch.float32)
    packed = kv_encode(vals[None], torch.ones(1), 4)
    assert torch.equal(widen_int4(unpack_int4(packed)).float()[0], vals)


@pytest.mark.parametrize("q_dtype,kv_bits,hd,bs,want", [
    (torch.bfloat16, 8, 128, 16, pa.TENSOR_CORE),   # the serve path
    (torch.bfloat16, 4, 128, 16, pa.TENSOR_CORE),
    (torch.bfloat16, 8, 4, 16, pa.TENSOR_CORE),     # 4-byte int8 rows
    (torch.bfloat16, 4, 8, 512, pa.TENSOR_CORE),    # 4-byte rows, one page
    (torch.bfloat16, 8, 14, 16, pa.CUDA_CORE),      # 14-byte rows
    (torch.bfloat16, 4, 12, 16, pa.CUDA_CORE),      # 6-byte rows
    (torch.bfloat16, 4, 14, 4, pa.CUDA_CORE),       # 7-byte rows
    (torch.bfloat16, 8, 128, 1024, pa.CUDA_CORE),   # a split of 1024 keys
    (torch.float32, 8, 128, 16, pa.CUDA_CORE),      # f32 q
    (torch.float32, 4, 128, 16, pa.CUDA_CORE),
])
def test_paged_quant_dispatch_rule(q_dtype, kv_bits, hd, bs, want):
    assert pa.quant_kernel(q_dtype, kv_bits, hd, bs) == want
