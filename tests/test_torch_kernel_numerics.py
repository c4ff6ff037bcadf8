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
"""
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
