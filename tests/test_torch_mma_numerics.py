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
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain

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


def _online_step(s, v, m, l, acc, split_p):
    """One online-softmax step over scores s (..., rows, keys) in log2
    units, -inf where masked; returns the new (m, l, acc)."""
    mx = torch.maximum(m, s.amax(-1))
    base = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
    corr = torch.exp2(m - base)
    p = torch.exp2(s - base[..., None])
    return mx, l * corr + p.sum(-1), acc * corr[..., None] + _pv(p, v,
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


def paged_emulated(q, k_pool, v_pool, bt, lens, *, window=0, split_p=True):
    """q (B, H, hd) bf16 over bf16 pages (NB, BS, KV, hd) -> bf16."""
    B, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    scale = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=torch.float32)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        pos = torch.arange(n)
        rows = bt[b, pos // BS].long() * BS + pos % BS
        kf, vf = (p.reshape(-1, KV, hd)[rows].float().permute(1, 0, 2)
                  .repeat_interleave(G, 0) for p in (k_pool, v_pool))
        qb = q[b].float()[:, None, :]                      # (H, 1, hd)
        k_lo = max(0, n - window) if window > 0 else 0
        parts = []                                         # (m_nat, l, acc)
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
                    s = (qb @ kf[:, a:z].transpose(-1, -2)) * scale
                    warps[w] = _online_step(s, vf[:, a:z], *warps[w],
                                            split_p)
            mx = torch.stack([w[0] for w in warps]).amax(0)
            wgt = [torch.exp2(w[0] - mx) for w in warps]
            parts.append((mx * math.log(2.0),
                          sum(g * w[1] for g, w in zip(wgt, warps)),
                          sum(g[..., None] * w[2] for g, w in zip(wgt,
                                                                  warps))))
        big_m = torch.stack([p[0] for p in parts]).amax(0)
        total_l, total = torch.zeros(H, 1), torch.zeros(H, 1, hd)
        for m, l, acc in parts:
            wgt = torch.exp(m - big_m)
            total_l = total_l + wgt * l
            total = total + wgt[..., None] * acc
        out[b] = (total / total_l.clamp_min(1e-20)[..., None])[:, 0]
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
