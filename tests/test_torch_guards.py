"""The port's numeric guards (repro_torch.core.guards) against the JAX
package's (repro.core.guards): sentinels and dead columns, escalating
damping, the fallback chain down to data-free RTN, damped_inverse, the
NaN-tap sentinel through the real pipeline on the fused path, and a
healthy guarded run giving the unguarded run's codes bit for bit."""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.core import GuardContext as JGuardContext
from repro.core import QuantSpec as JSpec
from repro.core import damped_inverse as jax_damped_inverse
from repro.core import guarded_solve as jax_guarded_solve
from repro.core import quantize_model as jax_quantize
from repro.core.guards import gram_health as jax_gram_health
from repro.ft import FaultInjector
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import (GuardContext, QuantSpec, damped_inverse,
                              gptq_quantize, guarded_solve, quantize_model)
from repro_torch.core import pipeline as pl
from repro_torch.core.guards import (DAMP_MULTS, gram_health,
                                     sanitize_array, solver_chain)
from repro_torch.ft import FaultInjector as TFaultInjector
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=2,
            order="greedy")
M, N = 16, 8          # input dim, output columns of the unit-level solves
# per-leaf errors: the bf16 taps differ by rounding between the frameworks
# (tests/test_torch_pipeline.py)
ERR_RTOL = 0.05


def _xw(seed=0, n_samples=256):
    rs = np.random.RandomState(seed)
    return (rs.randn(n_samples, M).astype(np.float32),
            rs.randn(M, N).astype(np.float32))


def _gram(x):
    return x.T @ x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _finite(r):
    return all(bool(torch.isfinite(torch.as_tensor(v).float()).all())
               for v in (r.delta, r.errors, r.q))


def _events(gctx):
    return [(e.layer, e.name, e.kind, e.detail) for e in gctx.events]


# ---------------------------------------------------------------------------
# sentinels and dead columns
# ---------------------------------------------------------------------------

def test_sanitize_array_passes_clean_input_through():
    x = _t(_xw()[0])
    out, n = sanitize_array(x)
    assert n == 0 and out is x
    bad = x.clone()
    bad[3, 2], bad[0, 0] = float("nan"), float("inf")
    out, n = sanitize_array(bad)
    assert n == 2 and bool(torch.isfinite(out).all())
    assert float(out[3, 2]) == 0.0 and torch.equal(out[1:3], x[1:3])


def test_gram_health_counts_match_jax():
    x, w = _xw()
    x[:, 3] = x[:, 7] = 0.0
    h = _gram(x)
    h[0, 1] = np.nan
    w[2, 2] = np.inf
    w0 = np.zeros_like(w)
    w0[5, 5] = np.nan
    got = gram_health(_t(h), [_t(w), _t(w0)])
    want = jax_gram_health(jnp.asarray(h), [jnp.asarray(w), jnp.asarray(w0)])
    assert got == (1, 2, [1, 1]) == tuple(want[:2]) + (want[2],)


@pytest.mark.parametrize("method", ["comq", "comq_blocked", "rtn"])
def test_dead_columns_finite_and_recorded_as_jax(method):
    """All-zero activation channels: the Gram diagonal dies, every solver
    rounds those rows plainly, and the guard records (without escalating)
    how many — the same events as JAX."""
    x, w = _xw()
    x[:, 4:9] = 0.0
    h = _gram(x)
    gctx, jctx = GuardContext(), JGuardContext()
    r = guarded_solve(_t(h), _t(w), QuantSpec(**SPEC), method, gctx=gctx)
    jax_guarded_solve(jnp.asarray(h), jnp.asarray(w), JSpec(**SPEC), method,
                      gctx=jctx)
    assert _finite(r)
    assert _events(gctx) == _events(jctx)
    assert [e.detail["count"] for e in gctx.events] == [5]


def test_nonfinite_gram_and_weight_sanitized_and_recorded():
    x, w = _xw()
    h = _gram(x)
    h[0, 0] = np.nan
    w[1, 1] = np.inf
    gctx, jctx = GuardContext(), JGuardContext()
    with pytest.warns(UserWarning, match="nonfinite_"):
        r = guarded_solve(_t(h), _t(w), QuantSpec(**SPEC), "comq_blocked",
                          gctx=gctx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = jax_guarded_solve(jnp.asarray(h), jnp.asarray(w),
                               JSpec(**SPEC), "comq_blocked", gctx=jctx)
    assert _finite(r)
    assert {"nonfinite_gram", "nonfinite_weight"} <= \
        {e.kind for e in gctx.events}
    assert _events(gctx) == _events(jctx)
    np.testing.assert_array_equal(r.q.numpy(), np.asarray(jr.q))


@pytest.mark.parametrize("method", ["comq", "comq_blocked", "rtn", "gptq"])
def test_guarded_healthy_solve_is_the_unguarded_solve(method):
    x, w = _xw()
    h, w = _t(_gram(x)), _t(w)
    gctx = GuardContext()
    spec = QuantSpec(**SPEC)
    r0 = pl.solve(h, w, spec, method)
    r1 = guarded_solve(h, w, spec, method, gctx=gctx)
    assert torch.equal(r0.q, r1.q) and torch.equal(r0.delta, r1.delta)
    assert torch.equal(r0.errors, r1.errors)
    assert gctx.events == []
    off = guarded_solve(h, w, spec, method, gctx=GuardContext(enabled=False))
    assert torch.equal(off.q, r0.q)


# ---------------------------------------------------------------------------
# damping escalation and the fallback chain (forced through solve_fn)
# ---------------------------------------------------------------------------

_BAD = types.SimpleNamespace(q=torch.zeros(M, N, dtype=torch.int32),
                             delta=torch.full((N,), float("nan")),
                             errors=torch.tensor([float("nan")]))


def test_solver_chain_matches_jax():
    from repro.core.guards import solver_chain as jax_chain
    for method in ("comq", "comq_blocked", "rtn", "gptq"):
        assert solver_chain(method) == jax_chain(method)


def test_damping_escalation_recorded():
    """A solve that survives only under damping succeeds at the first
    escalation step and records it."""
    x, w = _xw()
    h0, w = _t(_gram(x)), _t(w)

    def flaky(h, w2d, spec, method, block=256, schedule=None):
        if method != "rtn" and torch.equal(h, h0):
            return _BAD                      # fails undamped
        return pl.solve(h, w2d, spec, method, block=block,
                        schedule=schedule)

    gctx = GuardContext()
    with pytest.warns(UserWarning, match="damping_escalated"):
        r = guarded_solve(h0, w, QuantSpec(**SPEC), "comq_blocked",
                          gctx=gctx, solve_fn=flaky, presanitized=True)
    assert _finite(r)
    ev = [e for e in gctx.events if e.kind == "damping_escalated"]
    assert ev and ev[0].detail == {"mult": DAMP_MULTS[0],
                                   "solver": "comq_blocked"}
    assert not [e for e in gctx.events if e.kind == "fallback"]


def test_refresh_schedule_is_the_first_fallback():
    """A trailing-update solve that fails at every damping lands on the
    per-panel-refresh schedule, recorded as a fallback."""
    x, w = _xw()
    h, w = _t(_gram(x)), _t(w)
    seen = []

    def trailing_broken(h, w2d, spec, method, block=256, schedule=None):
        seen.append((method, schedule))
        if schedule == "trailing":
            return _BAD
        return pl.solve(h, w2d, spec, method, block=block, schedule=schedule)

    gctx = GuardContext()
    with pytest.warns(UserWarning, match="fallback"):
        r = guarded_solve(h, w, QuantSpec(**SPEC), "comq_blocked", gctx=gctx,
                          solve_fn=trailing_broken, presanitized=True)
    assert seen[:5] == [("comq_blocked", "trailing")] * 5
    assert seen[5] == ("comq_blocked", "refresh")
    assert [(e.kind, e.detail) for e in gctx.events] == \
        [("fallback", {"solver": "comq_blocked:refresh"})]
    ref = pl.solve(h, w, QuantSpec(**SPEC), "comq_blocked",
                   schedule="refresh")
    assert torch.equal(r.q, ref.q)


def test_fallback_chain_lands_on_rtn():
    x, w = _xw()

    def broken(h, w2d, spec, method, block=256, schedule=None):
        if method == "rtn":
            return pl.solve(h, w2d, spec, "rtn")
        return _BAD

    gctx = GuardContext()
    with pytest.warns(UserWarning, match="fallback"):
        r = guarded_solve(_t(_gram(x)), _t(w), QuantSpec(**SPEC),
                          "comq_blocked", gctx=gctx, solve_fn=broken,
                          presanitized=True)
    assert _finite(r)
    assert any(e.kind == "fallback" and e.detail["solver"] == "rtn"
               for e in gctx.events)


def test_fallback_last_resort_is_data_free_rtn():
    x, w = _xw()

    def hopeless(h, w2d, spec, method, block=256, schedule=None):
        return _BAD

    gctx = GuardContext()
    with pytest.warns(UserWarning, match="fallback"):
        r = guarded_solve(_t(_gram(x)), _t(w), QuantSpec(**SPEC),
                          "comq_blocked", gctx=gctx, solve_fn=hopeless,
                          presanitized=True)
    assert _finite(r)
    assert [e.detail for e in gctx.events] == [{"solver": "rtn_no_h"}]


def test_exploded_error_counts_as_failure():
    """A finite solve whose error lands past 10x the RTN reference has
    diverged: the guard escalates instead of accepting it."""
    x, w = _xw()
    h, w = _t(_gram(x)), _t(w)

    def exploding(h2, w2d, spec, method, block=256, schedule=None):
        r = pl.solve(h2, w2d, spec, method, block=block, schedule=schedule)
        if method != "rtn" and torch.equal(h2, h):
            r.errors = r.errors * 1e3
        return r

    gctx = GuardContext()
    with pytest.warns(UserWarning, match="damping_escalated"):
        guarded_solve(h, w, QuantSpec(**SPEC), "comq", gctx=gctx,
                      solve_fn=exploding, presanitized=True)
    assert [e.kind for e in gctx.events] == ["damping_escalated"]


# ---------------------------------------------------------------------------
# damped_inverse and the GPTQ baseline that uses it
# ---------------------------------------------------------------------------

def test_damped_inverse_escalates_then_scrubs():
    h = np.zeros((M, M), np.float32)
    h[0, 0] = np.inf
    hinv, mult = damped_inverse(_t(h), start=0.01, max_tries=4)
    jhinv, jmult = jax_damped_inverse(jnp.asarray(h), start=0.01,
                                      max_tries=4)
    assert bool(torch.isfinite(hinv).all())
    assert mult == pytest.approx(0.01 * 10 ** 4) == float(jmult)
    np.testing.assert_array_equal(hinv.numpy(), np.asarray(jhinv))


def test_damped_inverse_healthy_no_escalation_matches_jax():
    x, _ = _xw()
    hinv, mult = damped_inverse(_t(_gram(x)), start=0.01)
    jhinv, jmult = jax_damped_inverse(jnp.asarray(_gram(x)), start=0.01)
    assert mult == pytest.approx(0.01) == pytest.approx(float(jmult))
    np.testing.assert_allclose(hinv.numpy(), np.asarray(jhinv), rtol=1e-4,
                               atol=1e-7)


def test_gptq_degenerate_hessians_stay_finite():
    x, w = _xw()
    x[:, 1:] = x[:, :1]                      # rank-1 activations
    assert _finite(gptq_quantize(_t(_gram(x)), _t(w), QuantSpec(**SPEC)))
    assert _finite(gptq_quantize(torch.zeros(M, M), _t(w),
                                 QuantSpec(**SPEC)))


# ---------------------------------------------------------------------------
# the guards through the real pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (4, 64)).astype(
        np.int32)


def test_nan_tap_on_the_fused_path_matches_jax(jparams, tokens):
    """A NaN in the first tap (the wq|wk|wv shared tap, column-fused under
    the cyclic order): the sentinel zeroes it, records nonfinite_tap for
    each leaf of the group, annotates the per-leaf report, and the run
    stays finite — with JAX's events and per-leaf errors."""
    spec = dict(SPEC, order="cyclic")
    inj = FaultInjector({"nan_tap": [1]})
    with pytest.warns(UserWarning, match="nonfinite_tap"):
        _, jrep = jax_quantize(jparams, jax_cfg(ARCH), JPlan(remat=False),
                               jnp.asarray(tokens), JSpec(**spec),
                               method="comq_blocked", injector=inj)
    tinj = TFaultInjector({"nan_tap": [1]})
    with pytest.warns(UserWarning, match="nonfinite_tap"):
        qp, rep = quantize_model(params_from_numpy(jparams, "cpu"),
                                 get_smoke_config(ARCH), tt.BuildPlan(),
                                 torch.from_numpy(tokens).long(),
                                 QuantSpec(**spec), method="comq_blocked",
                                 injector=tinj)
    assert tinj.fired == inj.fired == [("nan_tap", 1)]
    taps = [(e.layer, e.name, e.detail) for e in rep.guard_events
            if e.kind == "nonfinite_tap"]
    assert taps == [(0, n, {"count": 1})
                    for n in ("attn.wq", "attn.wk", "attn.wv")]
    assert [(e.layer, e.name, e.kind, e.detail) for e in rep.guard_events] \
        == [(e.layer, e.name, e.kind, e.detail) for e in jrep.guard_events]
    assert [lr.guard for lr in rep.layers] == [lr.guard for lr in jrep.layers]
    for jr, tr in zip(jrep.layers, rep.layers):
        assert np.isfinite(tr.err_after)
        np.testing.assert_allclose(tr.err_after, jr.err_after, rtol=ERR_RTOL,
                                   err_msg=tr.name)
    for lp in qp["__qlayers__"].values():
        for leaves in lp.values():
            for v in leaves.values():
                if isinstance(v, dict):
                    assert bool(torch.isfinite(v["scale"]).all())


@pytest.mark.parametrize("propagation", ["staged", "legacy"])
def test_guards_off_healthy_run_bit_identical(jparams, tokens, propagation):
    p = params_from_numpy(jparams, "cpu")
    runs = [quantize_model(p, get_smoke_config(ARCH), tt.BuildPlan(),
                           torch.from_numpy(tokens).long(), QuantSpec(**SPEC),
                           method="comq_blocked", propagation=propagation,
                           guards=g) for g in (False, True)]
    (q0, r0), (q1, r1) = runs
    assert r0.guard_events == r1.guard_events == []
    for l, lp in q0["__qlayers__"].items():
        for mod, leaves in lp.items():
            for leaf, a in leaves.items():
                b = q1["__qlayers__"][l][mod][leaf]
                if isinstance(a, dict):
                    for k in ("codes", "scale", "z_lo"):
                        assert torch.equal(a[k], b[k]), (l, mod, leaf, k)
                else:
                    assert torch.equal(a, b)
    assert [r.err_after for r in r0.layers] == [r.err_after for r in r1.layers]


def test_degenerate_calibration_completes_finite():
    """One repeated token id (near rank-1 taps) and fewer tokens than the
    widest input dim: the guards carry both runs to finite codes."""
    cfg = get_smoke_config(ARCH)
    from repro_torch.models import init_params
    p = init_params(cfg, seed=0, device="cpu")
    for tok in (torch.full((4, 64), 7, dtype=torch.long),
                torch.randint(0, 256, (1, 32),
                              generator=torch.Generator().manual_seed(0))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            qp, rep = quantize_model(p, cfg, tt.BuildPlan(), tok,
                                     QuantSpec(**SPEC), method="comq_blocked",
                                     quantize_unembed=True)
        assert all(np.isfinite(lr.err_after) for lr in rep.layers)
        assert rep.layers[-1].name == "unembed"
        assert bool(torch.isfinite(qp["unembed"]["scale"]).all())
