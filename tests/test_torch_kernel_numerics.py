"""The arithmetic of the redesigned `comq_panel` and `quant_matmul` kernels,
emulated in plain torch on the CPU and held against the plain versions and
the JAX oracles on shared numpy inputs.

- `csrc/quant_matmul.cu` splits an f32 X into three bf16 planes (hi, mid,
  lo), multiplies each by the exact bf16 codes with f32 accumulation over
  16-deep k steps, in split-K runs of kc rows (partial sums added split by
  split), takes ΣX in f32 and applies scale and zero-point last. The
  kernel plans kc itself (`quant_matmul.plan`, on the card); here the
  order is held at the kc it picks for these shapes and at others. A bf16 X is one plane. Held to the kernel's
  tolerance max|Δ| ≤ 1e-3·max|Y| (QMM_REL); the same with two planes
  (hi + lo) and with X in bf16 only (the TPU kernel's precision) is
  printed, not asserted.
- `csrc/comq_panel.cu` walks the panel in sub-panels of 16 rows: a
  column's chain inside a sub-panel is right-looking with fused
  multiply-adds, and after each sub-panel the rows below it take the
  rank-16 update, k in order. Held to chip_smoke's code agreement ≥ 0.999
  at chip_smoke's random-panel recipe. Its fast pass replaces the IEEE
  division by the reciprocal's product and redoes a sub-panel with the
  division where a quotient came near a rounding boundary; that the fast
  pass gives the same code everywhere else is checked on adversarial
  inputs.
- `csrc/flash_attention_bwd.cu` recomputes P = exp(scale·q·k − LSE) from
  the forward's LSE, sums D = rowsum(P·dP) and forms dS = P·(dP − D). In
  f32 (CUDA cores) all of it in f32; in bf16 (tensor cores) S and dP are
  f32 sums of exact bf16 products a 64-key (or 64-query) tile at a time,
  P and dS enter dQ, dK and dV as bf16 hi + lo, and dK / dV are summed
  over the planner's query splits in split order. Held against the plain
  version's autograd graph under the backward's tolerance, against
  JAX's `flash_attention_ref` VJP on the same numpy inputs, and on
  near-hard scores within REF_K (2x for bf16) of the plain version's
  distance from an f64 reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comq_hessian as jh
from repro.kernels import ref as jref
from repro_torch.core.comq_hessian import panel_sweep_dq_ref
from repro_torch.core.quantizer import pack_codes
from repro_torch.kernels import quant_matmul

torch.set_num_threads(2)

QMM_REL = 1e-3
PANEL_MIN_CODE_AGREEMENT = 0.999
KC = 128              # the kernel's split-K run at M=8 K=3584 N=512 on
                      # the H100's 132 SMs (test_torch_cuda checks it)
SUB = 16              # rows of a panel sub-panel (csrc/comq_panel.cu)
EPS = 1e-12


def _bf16(x):
    return x.to(torch.bfloat16).float()


def planes(x, n):
    """x as n bf16 planes, each the bf16 rounding of what the previous
    ones left (n = 1 for a bf16 X)."""
    out, rest = [], x.float()
    for _ in range(n):
        out.append(_bf16(rest))
        rest = rest - out[-1]
    return out


def qmm_emulated(x, u, scale, z, n_planes=3, kc=KC):
    """x (M, K) f32 (split into `n_planes`) or bf16 (one plane), u (K, N)
    unpacked codes -> (M, N) f32, in the kernel's order: per split-K run of
    kc rows, 16-deep k steps of bf16 products accumulated in f32; runs
    summed in order; ΣX over the whole row in f32."""
    M, K = x.shape
    N = u.shape[1]
    ksplit = -(-K // kc)
    ps = planes(x, n_planes if x.dtype == torch.float32 else 1)
    uf = u.float()
    acc = torch.zeros(M, N)
    for s in range(ksplit):
        part = torch.zeros(M, N)
        for k0 in range(s * kc, min(K, (s + 1) * kc), 16):
            ks = slice(k0, min(K, k0 + 16))
            for p in ps:
                part = part + p[:, ks] @ uf[ks]
        acc = acc + part
    rs = x.float().sum(1)
    return acc * scale + rs[:, None] * (scale * z)


def _qmm_inputs(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    u = rng.integers(0, 2 ** bits, (K, N)).astype(np.uint8)
    scale = rng.uniform(0.01, 0.05, N).astype(np.float32)
    z = rng.integers(-(2 ** (bits - 1)), 0, N).astype(np.float32)
    return x, u, scale, z


@pytest.mark.parametrize("bits,xdt", [(2, "f32"), (4, "f32"), (8, "f32"),
                                      (4, "bf16")])
def test_qmm_x_planes_design_holds_the_tolerance(bits, xdt):
    M, K, N = 8, 3584, 512
    x, u, scale, z = _qmm_inputs(M, K, N, bits, seed=bits)
    if xdt == "bf16":      # round once, so every party sees the same X
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    tx = torch.from_numpy(x)
    if xdt == "bf16":
        tx = tx.bfloat16()
    tu, ts, tz = (torch.from_numpy(a) for a in (u, scale, z))
    codes, cpb = pack_codes(tu, bits)
    plain = quant_matmul.quant_matmul_plain(tx, codes, ts, tz, cpb=cpb)
    oracle = torch.from_numpy(np.array(jref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(scale),
        jnp.asarray(z))))
    got = qmm_emulated(tx, tu, ts, tz)
    rels = [float((got - want).abs().max() / want.abs().max())
            for want in (plain, oracle)]
    fewer = [float((qmm_emulated(tx.float(), tu, ts, tz, n) - plain)
                   .abs().max() / plain.abs().max()) for n in (2, 1)]
    print(f"quant_matmul bits={bits} x={xdt}: kernel order rel "
          f"{rels[0]:.3e} (plain), {rels[1]:.3e} (JAX oracle); X in two "
          f"planes rel {fewer[0]:.3e}, in bf16 only {fewer[1]:.3e}")
    assert max(rels) <= QMM_REL


@pytest.mark.parametrize("kc", [64, 448, 1216, 3584])
def test_qmm_split_k_order_holds_the_tolerance(kc):
    """Any run length the plan may pick (from 56 runs of one stage to one
    run of the whole K) keeps the f32-X result inside QMM_REL."""
    M, K, N = 8, 3584, 512
    x, u, scale, z = _qmm_inputs(M, K, N, 4, seed=10 + kc)
    tx, tu, ts, tz = (torch.from_numpy(a) for a in (x, u, scale, z))
    codes, cpb = pack_codes(tu, 4)
    plain = quant_matmul.quant_matmul_plain(tx, codes, ts, tz, cpb=cpb)
    got = qmm_emulated(tx, tu, ts, tz, kc=kc)
    rel = float((got - plain).abs().max() / plain.abs().max())
    print(f"quant_matmul split-K runs of {kc}: rel {rel:.3e}")
    assert rel <= QMM_REL


def fast_round_emulated(s, denom, qg):
    """The fast pass of csrc/comq_panel.cu's chain in f32: v = s * (1 /
    denom) + qg in one fused multiply-add (emulated in f64, rounded
    once), rounded half to even; `near` marks where the kernel redoes the
    step with the IEEE quotient."""
    # rcp.approx: within 1 ulp of 1 / denom; here rounded, then moved by
    # one ulp (either way, alternately) to cover the approximation
    rcp = 1.0 / denom
    step = torch.where(torch.arange(len(rcp)) % 2 == 0, 1.0, -1.0)
    rcp = torch.nextafter(rcp, rcp + step * rcp.abs())
    v = (s.double() * rcp.double() + qg.double()).float()
    r = torch.round(v)
    margin = ((s * rcp).abs() + v.abs()) * 1.2e-6
    near = ~(((v - r).abs() - 0.5).abs() > margin)
    return r, near


def test_panel_fast_pass_matches_the_ieee_division():
    """Quotients steered onto and around half-integers: wherever the fast
    pass does not call for a redo, it rounds to the same code as
    rint(s / denom + qg) with the IEEE quotient."""
    rng = np.random.default_rng(0)
    n = 200_000
    denom = torch.from_numpy(rng.uniform(1e-3, 40.0, n).astype(np.float32))
    qg = torch.from_numpy((rng.standard_normal(n) * 5).astype(np.float32))
    target = torch.from_numpy(rng.integers(-20, 20, n).astype(np.float32)
                              + 0.5)
    ulps = torch.from_numpy(rng.integers(-40, 41, n).astype(np.float32))
    s = (target - qg) * denom
    s = s + ulps * torch.finfo(torch.float32).eps * s.abs()
    s = torch.cat([s, torch.from_numpy(
        (rng.standard_normal(n) * 30).astype(np.float32))])
    denom, qg = denom.repeat(2), qg.repeat(2)
    want = torch.round(s / denom + qg)
    got, near = fast_round_emulated(s, denom, qg)
    print(f"fast pass: {int(near.sum())} of {len(s)} quotients are near a "
          f"rounding boundary (redone with the division)")
    assert torch.equal(got[~near], want[~near])
    assert int(near.sum()) > 0


def panel_emulated(h_bb, s0, qf, delta, z_lo, z_hi, hdiag, sub=SUB):
    """The kernel's blocked sweep: fused multiply-adds are taken in f64
    and rounded once to f32."""
    B, n = qf.shape
    s = s0.clone()
    q_out, dq = qf.clone(), torch.zeros_like(qf)

    def fma_neg(h, dw, acc):           # acc - h * dw, rounded once
        return (acc.double() - h.double() * dw.double()).float()

    for st in range(0, B, sub):
        end = min(B, st + sub)
        for t in range(st, end):
            qg, hg = qf[t], hdiag[t]
            denom = delta * hg
            ratio = s[t] / torch.where(denom > 0, denom, torch.ones_like(
                denom))
            qn = torch.clamp(torch.round(ratio + qg), z_lo, z_hi)
            if not hg > EPS:
                qn = torch.clamp(torch.round(qg), z_lo, z_hi)
            dq[t] = (qn - qg) * delta
            q_out[t] = qn
            for u in range(t + 1, end):
                s[u] = fma_neg(h_bb[u, t], dq[t], s[u])
        for k in range(st, end):
            s[end:] = fma_neg(h_bb[end:, k:k + 1], dq[k], s[end:])
    return q_out, dq


def test_panel_blocked_design_holds_code_agreement():
    B, n = 256, 512
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4 * B, B)).astype(np.float32)
    h = (x.T @ x / (4 * B) + 0.1 * np.eye(B)).astype(np.float32)
    s0 = rng.standard_normal((B, n)).astype(np.float32)
    qf = (rng.standard_normal((B, n)) * 3).astype(np.float32)
    delta = (rng.random(n) * 0.15 + 0.05).astype(np.float32)
    z_lo = np.full(n, -8.0, np.float32)
    z_hi = np.full(n, 7.0, np.float32)
    hdiag = np.ascontiguousarray(np.diagonal(h))
    args = [torch.from_numpy(a) for a in (h, s0, qf, delta, z_lo, z_hi,
                                          hdiag)]
    got, got_dq = panel_emulated(*args)
    plain, _ = panel_sweep_dq_ref(*args)
    jax_q, _ = jh.panel_sweep_dq_ref(*(jnp.asarray(a) for a in (
        h, s0, qf, delta, z_lo, z_hi, hdiag)))
    agree = [float((got == want).float().mean())
             for want in (plain, torch.from_numpy(np.array(jax_q)))]
    print(f"comq_panel B={B} n={n} sub-panels of {SUB}: code agreement "
          f"{agree[0]:.6f} (plain), {agree[1]:.6f} (JAX)")
    assert min(agree) >= PANEL_MIN_CODE_AGREEMENT
    torch.testing.assert_close(got_dq, (got - args[2]) * args[3], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# csrc/flash_attention_bwd.cu: FlashAttention-2's backward from the LSE
# ---------------------------------------------------------------------------

def _flash_bwd_emulated(q, k, v, do, lse, causal, window):
    """The backward kernel's arithmetic in f32: P = exp(scale·q·k − LSE),
    D = rowsum(P·dP), dS = P·(dP − D); gradients rounded to the input
    dtype once, at the end."""
    from repro_torch.kernels.flash_attention import attention_mask
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / np.sqrt(hd)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (kf, vf))
    s = torch.einsum("bthd,bshd->bhts", qf, kx) * scale
    mask = attention_mask(Tq, Tk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bthd,bshd->bhts", dof, vx)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhts,bshd->bthd", ds, kx) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    fold = lambda t: t.reshape(B, Tk, KV, G, hd).sum(3)      # GQA group sum
    return tuple(t.to(q.dtype) for t in (dq, fold(dk), fold(dv)))


BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 8e-3)}
REF_K_BF16 = (2.0, 1e-4)     # chip_smoke.REF_K["bfloat16"]
LOG2E = 1.4426950408889634


def _hi_lo(x):
    """x as bf16 hi + lo (the kernel's split_pack), each widened to f32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _split_mm(a, b):
    """a @ b with a split into bf16 hi + lo, exact bf16 products summed in
    f32 (b holds bf16 values)."""
    hi, lo = _hi_lo(a)
    return hi @ b + lo @ b


def _walk_query_tiles(Tq, Tk, causal, window, k_lo, T=64):
    """(first, count) of the T-row query tiles that kernel B walks for the
    key block starting at k_lo: a mirror of the .cu kernel's own reckoning
    (q_first / q_end / t0 / nt), which the emulation walks."""
    k_last = min(k_lo + T, Tk) - 1
    q_first, q_end = 0, Tq
    if causal:
        q_first = k_lo
        if window > 0:
            q_end = min(Tq, k_last + window)
    t0 = q_first // T
    return t0, (-(-q_end // T) - t0 if q_end > q_first else 0)


def _split_pairs(n_pairs, nsplit, split):
    """[lo, hi) of a key block's n_pairs (head, tile) pairs that split
    `split` of nsplit walks (the kernel's p_lo / p_hi): pair p is head p //
    count, tile first + p % count of `_walk_query_tiles`."""
    return split * n_pairs // nsplit, (split + 1) * n_pairs // nsplit


def _flash_bwd_tc_emulated(q, k, v, do, lse, causal, window, nsplit):
    """The bf16 tensor-core design (csrc/flash_attention_bwd.cu) in plain
    torch. Kernel A, per 64-key tile in order: S = Q·Kᵀ, dP = dO·Vᵀ, P =
    exp2(S·scale·log2e − LSE·log2e); D = Σ_tiles rowsum(P·dP); then dQ +=
    split(dS)·K. Kernel B, per 64-key block: the (head, 64-row query tile)
    pairs of `_walk_query_tiles`, split by `_split_pairs`, each split's
    dV += split(Pᵀ)·dO and dK += split(dSᵀ)·Q in pair order, splits
    summed in order. Tiles the kernels skip contribute exact zeros
    here."""
    from repro_torch.kernels import flash_attention as fa
    T = fa.BWD_TILE
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / np.sqrt(hd)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (kf, vf))  # (B,H,T,d)
    mask = fa.attention_mask(Tq, Tk, causal, window, q.device)
    lse2 = lse * LOG2E                                          # (B, H, Tq)
    sl2 = np.float32(scale * LOG2E)

    def probs(s, lse_rows, m):
        return torch.where(m, torch.exp2(s * sl2 - lse_rows), 0.0)

    tiles = [slice(t0, min(t0 + T, Tk)) for t0 in range(0, Tk, T)]
    # kernel A: D, then dQ
    d = torch.zeros(B, H, Tq)
    for ks in tiles:
        p = probs(qf @ kx[:, :, ks].transpose(-1, -2), lse2[..., None],
                  mask[:, ks])
        d = d + (p * (dof @ vx[:, :, ks].transpose(-1, -2))).sum(-1)
    dq = torch.zeros(B, H, Tq, hd)
    for ks in tiles:
        p = probs(qf @ kx[:, :, ks].transpose(-1, -2), lse2[..., None],
                  mask[:, ks])
        ds = p * (dof @ vx[:, :, ks].transpose(-1, -2) - d[..., None])
        dq = dq + _split_mm(ds, kx[:, :, ks])
    # kernel B: per key block, the group's pairs in splits
    dk, dv = torch.zeros(B, KV, Tk, hd), torch.zeros(B, KV, Tk, hd)
    qg, dog = (t.reshape(B, KV, G, Tq, hd) for t in (qf, dof))
    lg, dg = (t.reshape(B, KV, G, Tq) for t in (lse2, d))
    for ks in tiles:
        t0, nt = _walk_query_tiles(Tq, Tk, causal, window, ks.start, T)
        parts = []
        for sp in range(nsplit):
            acc_k = torch.zeros(B, KV, ks.stop - ks.start, hd)
            acc_v = torch.zeros_like(acc_k)
            for pr in range(*_split_pairs(G * nt, nsplit, sp)):
                hh, qs = pr // nt, (t0 + pr % nt) * T
                qs = slice(qs, min(qs + T, Tq))
                qt, dot = qg[:, :, hh, qs], dog[:, :, hh, qs]
                pt = probs(kf[:, :, ks] @ qt.transpose(-1, -2),
                           lg[:, :, hh, None, qs], mask[qs, ks].T)
                dst = pt * (vf[:, :, ks] @ dot.transpose(-1, -2)
                            - dg[:, :, hh, None, qs])
                acc_v = acc_v + _split_mm(pt, dot)
                acc_k = acc_k + _split_mm(dst, qt)
            parts.append((acc_k, acc_v))
        sk, sv = parts[0]
        for pk, pv in parts[1:]:
            sk, sv = sk + pk, sv + pv
        dk[:, :, ks], dv[:, :, ks] = sk, sv
    return tuple(t.transpose(1, 2).to(q.dtype)
                 for t in (dq * np.float32(scale), dk * np.float32(scale),
                           dv))


def _attention_f64(q, k, v, causal, window):
    """The masked softmax attention in f64 (the reference gradients are
    its autograd)."""
    from repro_torch.kernels.flash_attention import attention_mask
    B, Tq, H, hd = q.shape
    G = H // k.shape[2]
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, kx) / np.sqrt(hd)
    mask = attention_mask(Tq, k.shape[1], causal, window, q.device)
    p = torch.softmax(s.masked_fill(~mask, -np.inf), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vx)


def _jax_ref_grads(q, k, v, do, causal, window):
    """jax.vjp of repro.kernels.ref.flash_attention_ref on the same values
    (as f32 numpy), in the model's layout."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    flat = lambda t: jnp.asarray(t.float().transpose(1, 2).reshape(
        -1, t.shape[1], hd).numpy())
    out, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), flat(q), flat(k), flat(v))
    grads = vjp(flat(do))
    return [torch.from_numpy(np.array(g)).reshape(B, n, T, hd)
            .transpose(1, 2) for g, n, T in zip(grads, (H, KV, KV),
                                                (Tq, Tk, Tk))]


def _within_bwd_tol(a, b, dtype):
    rel_max, rel = BWD_TOL[dtype]
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= rel_max * b.abs().max()
                 + rel * b.abs()).all())


@pytest.mark.parametrize("case", [
    dict(B=2, Tq=48, Tk=48, H=14, KV=2, hd=32, causal=True, window=0),
    dict(B=1, Tq=70, Tk=70, H=6, KV=3, hd=16, causal=True, window=20),
    dict(B=2, Tq=9, Tk=41, H=8, KV=2, hd=64, causal=False, window=0),
    dict(B=1, Tq=40, Tk=40, H=8, KV=2, hd=64, causal=True, window=0,
         qscale=12),
    dict(B=1, Tq=150, Tk=150, H=6, KV=2, hd=32, causal=True, window=0,
         nsplit=2),
    dict(B=1, Tq=130, Tk=130, H=8, KV=2, hd=16, causal=True, window=70,
         nsplit=3),
    dict(B=1, Tq=40, Tk=140, H=4, KV=1, hd=64, causal=False, window=0,
         nsplit=3),
    dict(B=1, Tq=140, Tk=140, H=6, KV=2, hd=64, causal=True, window=0,
         qscale=12, nsplit=2)],
    ids=lambda c: "-".join(f"{k}{int(v)}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_design_holds_the_tolerance(case, dtype):
    """The backward's design at its input type (f32: CUDA cores; bf16:
    tensor cores with `nsplit` query splits of dK / dV) against the plain
    version's autograd graph, at unit-scale and near-hard (qscale)
    scores, under the tolerance the kernel is held to on the card
    (kernels/flash_attention.py: f32 1e-4·max|g| + 1e-4·|g|; bf16
    2e-2·max|g| + 8e-3·|g|). bf16 also: against jax.vjp of JAX's
    flash_attention_ref under the same tolerance and, on near-hard
    scores, within REF_K_BF16 of the plain version's distance from an
    f64 reference (chip_smoke 19(b)'s per-launch gate)."""
    from repro_torch.kernels import flash_attention as fa
    c = case
    g = torch.Generator().manual_seed(c["Tq"])
    q = (torch.randn(c["B"], c["Tq"], c["H"], c["hd"], generator=g)
         * c.get("qscale", 1)).to(dtype)
    k, v = (torch.randn(c["B"], c["Tk"], c["KV"], c["hd"], generator=g)
            .to(dtype) for _ in range(2))
    do = torch.randn(q.shape, generator=g).to(dtype)
    kw = dict(causal=c["causal"], window=c["window"])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw),
                               leaves, do)
    lse = fa.attention_lse_plain(q, k, **kw)
    if dtype == torch.float32:
        got = _flash_bwd_emulated(q, k, v, do, lse, c["causal"],
                                  c["window"])
    else:
        got = _flash_bwd_tc_emulated(q, k, v, do, lse, c["causal"],
                                     c["window"], c.get("nsplit", 1))
    for a, b in zip(got, want):
        assert _within_bwd_tol(a, b, dtype), float((a.float() - b.float())
                                                   .abs().max())
    if dtype == torch.float32:
        return
    for a, b in zip(got, _jax_ref_grads(q, k, v, do, **kw)):
        assert _within_bwd_tol(a, b, dtype), float((a.float() - b)
                                                   .abs().max())
    if "qscale" in c:
        leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
        ref = torch.autograd.grad(_attention_f64(*leaves, **kw), leaves,
                                  do.double())
        k_ref, floor = REF_K_BF16
        for a, b, r in zip(got, want, ref):
            ek = float((a.double() - r).abs().max())
            ep = float((b.double() - r).abs().max())
            print(f"near-hard {c}: |design - f64| {ek:.3e}, |plain - f64| "
                  f"{ep:.3e} (ratio {ek / ep:.3f})")
            assert ek <= k_ref * ep + floor * float(r.abs().max())


# (B, Tq, Tk, H, KV, hd, causal, window) of chip_smoke.BWD_CASES with the
# planner's nsplit on 132 SMs (an H100 SXM), then one key block
PLAN_CASES = [((8, 128, 128, 28, 4, 128, True, 0), 5),      # qwen
              ((1, 512, 512, 28, 4, 128, True, 0), 9),      # qwen
              ((8, 128, 128, 24, 8, 64, True, 0), 3),       # granite
              ((1, 2048, 2048, 25, 5, 64, True, 1024), 2),  # hymba
              ((8, 128, 128, 32, 32, 64, True, 0), 1),      # musicgen
              ((8, 128, 1601, 64, 8, 128, False, 0), 1),    # the VLM
              ((8, 197, 197, 12, 12, 64, False, 0), 1),     # vit
              ((1, 64, 64, 4, 1, 64, True, 0), 4)]


@pytest.mark.parametrize("shape,nsplit", PLAN_CASES,
                         ids=lambda x: "-".join(map(str, map(int, x)))
                         if isinstance(x, tuple) else str(x))
def test_backward_split_plan_covers_every_pair_once(shape, nsplit):
    """plan_bwd's split at the families' backward shapes: every (query
    head, 64-row query tile) pair in which some query sees a key of a
    64-key block lands in exactly one split of that block, no other pair
    is walked, and a shape whose dK/dV kernel already launches 2 x 132
    blocks is not split. The pair walk checked here is the emulation's
    mirror of the kernel's; the kernel's own walk is held by the `cuda`
    tests of tests/test_torch_cuda.py (split and unsplit plans against
    the plain autograd)."""
    from repro_torch.kernels import flash_attention as fa
    B, Tq, Tk, H, KV, hd, causal, window = shape
    T, G = fa.BWD_TILE, H // KV
    plan = fa.plan_bwd(B, Tq, Tk, H, KV, hd, 132)
    assert plan.nsplit == nsplit
    unsplit = -(-Tk // T) * KV * B * (2 if hd > 128 else 1)
    assert plan.blocks == unsplit * nsplit
    if unsplit >= 2 * 132:
        assert nsplit == 1
    mask = fa.attention_mask(Tq, Tk, causal, window, "cpu")
    n_qt = -(-Tq // T)
    for k0 in range(0, Tk, T):
        sees = mask[:, k0:k0 + T].any(1)
        want = {(hh, t) for hh in range(G) for t in range(n_qt)
                if bool(sees[t * T:(t + 1) * T].any())}
        t0, nt = _walk_query_tiles(Tq, Tk, causal, window, k0, T)
        walked = [(p // nt, t0 + p % nt) for s in range(nsplit)
                  for p in range(*_split_pairs(G * nt, nsplit, s))]
        assert len(walked) == len(set(walked)) and set(walked) == want
