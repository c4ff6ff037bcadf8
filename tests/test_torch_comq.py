"""COMQ solvers of the port: visit orders against JAX (ties included),
the in-port bit-exact invariants of tests/test_comq_solvers.py, the
cross-package error trajectory and code agreement, and the plain panel
sweep against both JAX panel implementations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comq as jcomq
from repro.core import comq_hessian as jh
from repro.kernels.comq_panel import comq_panel_dq_pallas
from repro_torch.core import comq as tcomq
from repro_torch.core import comq_hessian as th
from repro_torch.core.quantizer import QuantSpec as TSpec
from repro.core.quantizer import QuantSpec as JSpec
from repro_torch.kernels import comq_panel

torch.set_num_threads(2)


def _problem(seed=0, n_samples=256, m=96, n=48, scale=0.05):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_samples, m))
         * (1.0 + np.arange(m) / m)).astype(np.float32)
    w = (rng.standard_normal((m, n)) * scale).astype(np.float32)
    h = (x.astype(np.float64).T @ x).astype(np.float32)
    return torch.from_numpy(h), torch.from_numpy(w)


@pytest.mark.parametrize("order", ["cyclic", "greedy", "greedy_shared"])
def test_make_orders_with_ties(order):
    # repeated |w| values and equal column norms: stable sorts must visit
    # tied coordinates in index order in both packages (powers of two, so
    # row norms are exact whatever the summation order)
    rng = np.random.default_rng(3)
    w = rng.choice([-0.5, -0.25, 0.25, 0.5], size=(24, 6)).astype(np.float32)
    norms = rng.choice([1.0, 2.0], size=24).astype(np.float32)
    want = np.asarray(jcomq.make_orders(order, jnp.asarray(norms),
                                        jnp.asarray(w)))
    got = tcomq.make_orders(order, torch.from_numpy(norms),
                            torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gran", ["per_layer", "per_channel"])
@pytest.mark.parametrize("order", ["cyclic", "greedy_shared"])
@pytest.mark.parametrize("block", [16, 32, 96])
def test_blocked_equals_row_at_a_time(gran, order, block):
    h, w = _problem()
    spec = TSpec(bits=4, granularity=gran, lam=0.9, sweeps=2, order=order)
    rh = th.comq_quantize_h(h, w, spec)
    rb = th.comq_quantize_blocked(h, w, spec, block=block)
    assert torch.equal(rh.q, rb.q)


@pytest.mark.parametrize("gran", ["per_layer", "per_channel"])
@pytest.mark.parametrize("order", ["cyclic", "greedy_shared"])
def test_trailing_blocked_padded_rows(gran, order):
    h, w = _problem()                     # m=96 padded to 128 at block=64
    spec = TSpec(bits=4, granularity=gran, lam=0.9, sweeps=3, order=order)
    rh = th.comq_quantize_h(h, w, spec)
    rb = th.comq_quantize_blocked(h, w, spec, block=64)
    assert torch.equal(rh.q, rb.q)
    np.testing.assert_allclose(rb.delta.numpy(), rh.delta.numpy(),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("gran", ["per_layer", "per_channel"])
def test_trailing_equals_refresh_schedule(gran):
    h, w = _problem()
    spec = TSpec(bits=4, granularity=gran, lam=0.9, sweeps=3,
                 order="greedy_shared")
    rt = th.comq_quantize_blocked(h, w, spec, block=32)
    rr = th.comq_quantize_blocked(h, w, spec, block=32, schedule="refresh")
    assert torch.equal(rt.q, rr.q)
    np.testing.assert_allclose(rt.errors.numpy(), rr.errors.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver", ["blocked", "h"])
@pytest.mark.parametrize("gran", ["per_layer", "per_channel"])
@pytest.mark.parametrize("order", ["greedy", "cyclic"])
def test_cross_package_trajectory_and_codes(solver, gran, order):
    h, w = _problem(seed=5)
    kw = dict(bits=4, granularity=gran, lam=0.9, sweeps=3, order=order)
    if solver == "blocked":
        rj = jh.comq_quantize_blocked(jnp.asarray(h.numpy()),
                                      jnp.asarray(w.numpy()), JSpec(**kw),
                                      block=32)
        rt = th.comq_quantize_blocked(h, w, TSpec(**kw), block=32)
    else:
        rj = jh.comq_quantize_h(jnp.asarray(h.numpy()),
                                jnp.asarray(w.numpy()), JSpec(**kw))
        rt = th.comq_quantize_h(h, w, TSpec(**kw))
    agree = float(np.mean(rt.q.numpy() == np.asarray(rj.q)))
    print(f"{solver}/{gran}/{order}: code agreement with JAX {agree:.4f}")
    assert agree >= 0.99
    np.testing.assert_allclose(rt.errors.numpy(), np.asarray(rj.errors),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bn", [(16, 32), (32, 64), (64, 96)])
def test_plain_panel_matches_both_jax_panels(bn):
    """The tests/test_kernels.py panel cases: the port's plain panel
    against panel_sweep_dq_ref and the Pallas kernel in interpret mode."""
    B, n = bn
    rng = np.random.default_rng(B * n)
    hh = rng.standard_normal((B, 4 * B)).astype(np.float32)
    h_bb = (hh @ hh.T / (4 * B) + np.eye(B) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, n)).astype(np.float32)
    qf = (rng.standard_normal((B, n)) * 3).astype(np.float32)
    delta = rng.uniform(0.05, 0.2, n).astype(np.float32)
    z_lo = np.full((n,), -8.0, np.float32)
    z_hi = np.full((n,), 7.0, np.float32)
    hdiag = np.diag(h_bb).copy()
    jargs = [jnp.asarray(a) for a in (h_bb, s0, qf, delta, z_lo, z_hi,
                                      hdiag)]
    ref_q, ref_dq = jh.panel_sweep_dq_ref(*jargs)
    pal_q, _ = comq_panel_dq_pallas(*jargs, col_block=32, interpret=True)
    got_q, got_dq = comq_panel.comq_panel_dq_plain(
        *[torch.from_numpy(a) for a in (h_bb, s0, qf, delta, z_lo, z_hi,
                                        hdiag)])
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(pal_q))
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(ref_dq), rtol=1e-6,
                               atol=0)


def test_padded_panel_rows_keep_their_code():
    """A zero-diagonal (padded) row keeps its rounded, clipped code."""
    B, n = 8, 5
    h_bb = torch.eye(B)
    h_bb[5:, 5:] = 0
    qf = torch.linspace(-9.6, 9.4, B * n).reshape(B, n)
    s0 = torch.randn(B, n, generator=torch.Generator().manual_seed(0))
    args = (h_bb, s0, qf, torch.full((n,), 0.1),
            torch.full((n,), -8.0), torch.full((n,), 7.0),
            torch.diagonal(h_bb).contiguous())
    q, dq = comq_panel.comq_panel_dq_plain(*args)
    np.testing.assert_array_equal(q[5:].numpy(),
                                  torch.clamp(torch.round(qf[5:]), -8,
                                              7).numpy())
