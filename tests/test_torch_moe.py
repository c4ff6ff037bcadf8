"""The port's MoE family against the JAX package on the granite-moe (E=4,
top-2) and llama4-maverick (E=4, top-1) smoke configs, both packages on
the JAX init converted through numpy: routing (ids and capacity slots),
apply_moe, forward logits and the expert taps, quantize_model with the
per-expert blocked solve, the group-batched expert guards, bit curves,
the expert .qpk exchange, fake quantization, and the serving runtime's
greedy tokens; plus the batched plain panel sweep against per-expert
sweeps and the family check."""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantSpec as JSpec
from repro.core import pipeline as jpl
from repro.core import quantize_model as jax_quantize
from repro.core.guards import GuardContext as JGuardContext
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core import pipeline as tpl
from repro_torch.core.guards import GuardContext
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
# per-leaf errors: the same tolerance as tests/test_torch_pipeline.py
ERR_RTOL = 0.05


def _jparams(arch, cfg=None):
    return jax.device_get(jax_init(jax.random.PRNGKey(0),
                                   cfg or jax_cfg(arch), JPlan(remat=False)))


@pytest.fixture(scope="module")
def jparams():
    return {a: _jparams(a) for a in (GRANITE, LLAMA4)}


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# routing and apply_moe
# ---------------------------------------------------------------------------

def _jax_slots(x, router, n_real, k, capacity):
    """The JAX layer's ids and slot positions (repro/models/moe.py
    _dispatch_chunk), computed with its own _route."""
    logits = jnp.einsum("nd,de->ne", x.astype(jnp.float32),
                        router.astype(jnp.float32))
    _, ids = jmoe._route(logits, n_real, k)
    onehot = jax.nn.one_hot(ids, router.shape[-1], dtype=jnp.int32)
    flat = onehot.reshape(-1, router.shape[-1])
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1)
    return np.asarray(ids), np.asarray(pos.reshape(ids.shape))


def _moe_case(arch, e_pad, cf):
    """A layer's MoE params (JAX init, `e_pad` experts) and the config
    with capacity factor `cf`."""
    cfg = jax_cfg(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(3), cfg, e_pad))
    return cfg, p


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,extra,cf,chunk", [
    (GRANITE, 0, 1.25, 4096),      # granite's own capacity
    (GRANITE, 0, 0.25, 4096),      # forced overflow
    (GRANITE, 2, 1.25, 4096),      # two padded experts
    (LLAMA4, 0, 1.25, 4096),
    (LLAMA4, 0, 0.5, 24),          # overflow, chunk halved 24 -> 12
])
def test_apply_moe_routes_and_combines_as_jax(arch, extra, cf, chunk, cd):
    jcfg, p = _moe_case(arch, jax_cfg(arch).moe.n_experts + extra, cf)
    jcfg = jcfg.replace(compute_dtype=cd)
    tcfg = get_smoke_config(arch).replace(compute_dtype=cd, moe=jcfg.moe)
    e_pad = p["router"].shape[-1]
    x = np.random.default_rng(9).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(cd))
    tx = torch.from_numpy(x).to(getattr(torch, cd))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    k, n_real = jcfg.moe.top_k, jcfg.moe.n_experts
    flat = tx.reshape(-1, jcfg.d_model)
    cap = tmoe._capacity(flat.shape[0], tcfg, 1)
    want_ids, want_pos = _jax_slots(jx.reshape(-1, jcfg.d_model),
                                    p["router"], n_real, k, cap)
    _, _, ids, pos, slot = tmoe.route_slots(flat, tp["router"], n_real, k,
                                            cap)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    assert int(ids.max()) < n_real
    if cf < 1:
        assert int((pos >= cap).sum()) > 0      # the overflow case drops
    assert bool((slot[pos >= cap] == e_pad * cap).all())

    # calibration path (taps: one whole-batch capacity) and the chunked one
    for taps in (True, False):
        jt_, tt_ = ({}, {}) if taps else (None, None)
        jy, jaux = jmoe.apply_moe(p, jx, jcfg, e_pad, token_chunk=chunk,
                                  taps=jt_)
        with torch.no_grad():
            ty, taux = tmoe.apply_moe(tp, tx, tcfg, e_pad,
                                      token_chunk=chunk, taps=tt_)
        assert_close(ty.float().numpy(), np.asarray(jy, np.float32), cd,
                     f"apply_moe taps={taps}")
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
        if taps:
            assert list(tt_) == list(jt_)
            for name in jt_:
                assert_close(tt_[name].float().numpy(),
                             np.asarray(jt_[name], np.float32), cd, name)


def test_decode_capacity_drops_no_token():
    """At 8 slots an expert gets at most 8 pairs (a token's k experts are
    distinct) and the capacity floor is 8: decode drops nothing."""
    for arch in (GRANITE, LLAMA4):
        cfg = get_smoke_config(arch)
        assert tmoe._capacity(tmoe.chunking(8, 4096), cfg, 1) >= 8


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_and_taps_match_jax(jparams, arch, cd):
    jc = jax_cfg(arch).replace(compute_dtype=cd)
    tc = get_smoke_config(arch).replace(compute_dtype=cd)
    jp = jparams[arch]
    tp = params_from_numpy(jp, "cpu")
    tok = _tokens(1, (2, 24))
    jl, jaux, _ = jm.forward(jp, jc, JPlan(remat=False), jnp.asarray(tok))
    with torch.no_grad():
        tl, taux, _ = tm.forward(tp, tc, BuildPlan(),
                                 torch.from_numpy(tok).long())
    assert_close(tl.float().numpy(), np.asarray(jl, np.float32), cd,
                 "logits")
    # bf16: the load-balance loss moves with the routing of the bf16
    # activations (a near-tie may route one token differently)
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-4 if cd == "float32" else 1e-2)

    jtaps, ttaps = {}, {}
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    jx = jm.embed_tokens(jp, jc, JPlan(), jnp.asarray(tok))
    jt.layer_full(lp0, jx, jc, JPlan(remat=False), False, taps=jtaps)
    with torch.no_grad():
        tx = tm.embed_tokens(tp, tc, BuildPlan(), torch.from_numpy(tok))
        tt.layer_full(tp["layers"][0], tx, tc, BuildPlan(), False,
                      taps=ttaps)
    assert list(ttaps) == list(jtaps)
    assert {"router_in", "expert_in", "expert_down_in"} <= set(ttaps)
    for name in jtaps:
        assert_close(ttaps[name].float().numpy(),
                     np.asarray(jtaps[name], np.float32), cd, name)


def test_param_count_matches_init_and_jax():
    from repro.models.model import count_params_analytic
    for arch in (GRANITE, LLAMA4):
        cfg = get_smoke_config(arch)
        p = tm.init_params(cfg, seed=0, device="cpu")
        n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
        assert tm.param_count(cfg) == n
        for active in (False, True):
            assert tm.param_count(cfg, active_only=active) == \
                count_params_analytic(jax_cfg(arch), active_only=active)
    from repro.configs import get_config as jax_full
    from repro_torch.configs import get_config
    for active in (False, True):
        assert tm.param_count(get_config(GRANITE), active) == \
            count_params_analytic(jax_full(GRANITE), active_only=active)


@pytest.mark.parametrize("change", [
    dict(attn_free=True), dict(parallel_ssm_heads=True),
    dict(family="vlm"), dict(family="encoder", causal=False),
    dict(family="ssm", attn_free=True, moe=None), dict(family="dense")])
def test_unported_families_still_raise(change):
    cfg = get_smoke_config(GRANITE).replace(**change)
    with pytest.raises(NotImplementedError, match="not a configuration"):
        tt.check_ported(cfg)
    tt.check_ported(get_smoke_config(GRANITE))


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _quantize_both(jp, arch, propagation="staged"):
    tok = _tokens(0, (2, 48))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 96 calibration tokens < d_ff
        jq, jrep = jax_quantize(jp, jax_cfg(arch), JPlan(remat=False),
                               jnp.asarray(tok), JSpec(**SPEC),
                               method="comq_blocked", guards=False,
                               propagation=propagation)
        tq, trep = quantize_model(params_from_numpy(jp, "cpu"),
                                  get_smoke_config(arch), BuildPlan(),
                                  torch.from_numpy(tok).long(),
                                  QuantSpec(**SPEC), method="comq_blocked",
                                  propagation=propagation)
    return jrep, tq, trep, jq


@pytest.fixture(scope="module")
def granite_runs(jparams):
    return _quantize_both(jparams[GRANITE], GRANITE)


def _assert_reports_match(jrep, trep):
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    assert any(r.name == "moe.w_down" for r in trep.layers)
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    assert trep.total_improvement() >= 0.3
    assert not trep.guard_events


def test_quantize_per_leaf_errors_match_jax_granite(granite_runs):
    jrep, tq, trep, _ = granite_runs
    _assert_reports_match(jrep, trep)
    qt = tq["__qlayers__"]["0"]["moe"]["w_gate"]
    E, d, f = get_smoke_config(GRANITE).moe.n_experts, 64, 32
    assert tuple(qt["codes"].shape) == (E, d, f)
    assert tuple(qt["scale"].shape) == (E, 1, f)
    assert qt["shape"] == (E, d, f) and qt["bits"] == 4


@pytest.mark.parametrize("arch,propagation", [(LLAMA4, "staged"),
                                              (GRANITE, "legacy")])
def test_quantize_per_leaf_errors_match_jax(jparams, arch, propagation):
    jrep, _, trep, _ = _quantize_both(jparams[arch], arch, propagation)
    _assert_reports_match(jrep, trep)


def test_batched_plain_panel_is_per_expert_panels():
    """The plain batched sweep is each expert's own sweep, bit for bit."""
    from repro_torch.kernels import comq_panel as panel
    g = torch.Generator().manual_seed(0)
    E, B, n = 4, 24, 10
    x = torch.randn(E, 3 * B, B, generator=g)
    h = torch.bmm(x.transpose(1, 2), x) / B
    args = (h, torch.randn(E, B, n, generator=g),
            torch.randn(E, B, n, generator=g) * 3,
            torch.rand(E, n, generator=g) * 0.2 + 0.05,
            torch.full((E, n), -8.0), torch.full((E, n), 7.0),
            torch.diagonal(h, dim1=1, dim2=2).contiguous())
    qb, db = panel.comq_panel_dq_plain(*args)
    for e in range(E):
        q1, d1 = panel.comq_panel_dq_plain(*(a[e] for a in args))
        assert torch.equal(qb[e], q1) and torch.equal(db[e], d1)


@pytest.mark.parametrize("gran", ["per_channel", "per_layer"])
def test_batched_blocked_solve_is_each_experts_solve(gran):
    """comq_quantize_blocked_experts solves each expert as the single
    blocked solver does (own order and grid): the codes agree and the
    errors match to rounding (batched vs single f32 products)."""
    from repro_torch.core.comq_hessian import (comq_quantize_blocked,
                                               comq_quantize_blocked_experts)
    g = torch.Generator().manual_seed(1)
    E, N, m, n = 3, 80, 40, 12
    xs = torch.randn(E, N, m, generator=g)
    hs = torch.bmm(xs.transpose(1, 2), xs)
    ws = torch.randn(E, m, n, generator=g)
    spec = QuantSpec(**{**SPEC, "granularity": gran})
    r = comq_quantize_blocked_experts(hs, ws, spec, block=16)
    assert tuple(r.q.shape) == (E, m, n)
    assert tuple(r.errors.shape) == (E, spec.sweeps + 1)
    for e in range(E):
        r1 = comq_quantize_blocked(hs[e], ws[e], spec, block=16)
        assert float((r.q[e] == r1.q).float().mean()) >= 0.99
        np.testing.assert_allclose(r.errors[e].numpy(), r1.errors.numpy(),
                                   rtol=1e-4)
        np.testing.assert_array_equal(r.z_lo[e].numpy(), r1.z_lo.numpy())


def test_batched_gram_matches_jax_and_caches_once():
    from repro.core.calibrate import batched_gram as jax_bg
    from repro_torch.core.calibrate import TapGramCache, batched_gram
    tap = np.random.default_rng(2).standard_normal((4, 12, 8)).astype(
        np.float32)
    tap[:, 9:] = 0.0                         # empty capacity slots
    got = batched_gram(torch.from_numpy(tap))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bg(tap)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bg(tap[:, :9])),
                               rtol=1e-5, atol=1e-5)
    cache = TapGramCache()
    for _ in range(2):
        assert torch.equal(cache.batched("expert_in", torch.from_numpy(tap)),
                           got)
    assert cache.computed == 1


# ---------------------------------------------------------------------------
# the group-batched expert guards
# ---------------------------------------------------------------------------

E_G, D_G, F_G = 3, 12, 8


def _guard_inputs():
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((E_G, 64, D_G)).astype(np.float32)
    hs = np.einsum("ecd,ecf->edf", xs, xs).astype(np.float32)
    ws = [rng.standard_normal((E_G, D_G, F_G)).astype(np.float32)
          for _ in range(2)]
    return hs, ws


def _events(gctx):
    return [(e.layer, e.name, e.kind, dict(e.detail)) for e in gctx.events]


def _jax_group(hs, ws, spec):
    gctx = JGuardContext()
    out = jpl._solve_group_experts([jnp.asarray(w) for w in ws],
                                   jnp.asarray(hs), [spec] * len(ws),
                                   "comq_blocked", gctx=gctx, layer=0,
                                   names=["moe.w_gate", "moe.w_up"])
    return out, _events(gctx)


def _port_group(hs, ws, spec):
    gctx = GuardContext()
    out = tpl._solve_group_experts([torch.from_numpy(w) for w in ws],
                                   torch.from_numpy(hs), [spec] * len(ws),
                                   "comq_blocked", gctx=gctx, layer=0,
                                   names=["moe.w_gate", "moe.w_up"])
    return out, _events(gctx)


def _assert_group_matches(jout, tout):
    for (jq, jeb, jea, _), (tq, teb, tea, _) in zip(jout, tout):
        assert tuple(tq["codes"].shape) == tuple(np.asarray(jq["codes"]).shape)
        assert np.isfinite(float(teb)) and np.isfinite(float(tea))
        assert torch.isfinite(tq["scale"]).all()
        np.testing.assert_allclose(float(tea), float(jea), rtol=ERR_RTOL)
        np.testing.assert_allclose(float(teb), float(jeb), rtol=ERR_RTOL)


def test_expert_group_poisoned_gram_events_match_jax():
    hs, ws = _guard_inputs()
    hs[1, 2, 3] = np.nan
    hs[2, 0, 0] = np.inf
    with pytest.warns(UserWarning, match="nonfinite_gram"):
        jout, jev = _jax_group(hs, ws, JSpec(**SPEC))
    with pytest.warns(UserWarning, match="nonfinite_gram"):
        tout, tev = _port_group(hs, ws, QuantSpec(**SPEC))
    assert tev == jev and [e[2] for e in tev] == ["nonfinite_gram"] * 2
    _assert_group_matches(jout, tout)


@pytest.mark.parametrize("fail", ["undamped", "always"])
def test_expert_group_escalation_and_fallback_match_jax(monkeypatch, fail):
    """A solve that fails undamped escalates the group's damping; one that
    always fails falls back to RTN for the whole group — the same events
    as the JAX package's chain."""
    hs, ws = _guard_inputs()
    # poisoned while H[0, 0] is undamped: with the experts' H[0, 0] made
    # equal (a larger diagonal keeps H positive definite), the first damped
    # retry (+1e-4 of the mean diagonal, ~6e-3 here) clears the threshold
    hs[:, 0, 0] = hs[:, 0, 0].max()
    thresh = (float(hs[0, 0, 0]) * 1.00001 if fail == "undamped"
              else float("inf"))

    real_j = jpl.solve

    def jsolve(h, w, spec, method="comq", block=256, schedule=None):
        r = real_j(h, w, spec, method, block=block, schedule=schedule)
        if method == "rtn":
            return r
        bad = jnp.where(h[0, 0] < thresh, jnp.nan, 1.0)
        return r._replace(delta=r.delta * bad) if hasattr(r, "_replace") \
            else dataclasses.replace(r, delta=r.delta * bad)

    real_t = tpl.solve_experts

    def tsolve(hs_, ws_, spec, method="comq", block=256):
        r = real_t(hs_, ws_, spec, method, block=block)
        if method == "rtn":
            return r
        bad = torch.where(hs_[:, 0, 0] < thresh, float("nan"), 1.0)
        return dataclasses.replace(r, delta=r.delta * bad[:, None])

    monkeypatch.setattr(jpl, "solve", jsolve)
    monkeypatch.setattr(tpl, "solve_experts", tsolve)
    kind = "damping_escalated" if fail == "undamped" else "fallback"
    with pytest.warns(UserWarning, match=kind):
        jout, jev = _jax_group(hs, ws, JSpec(**SPEC))
    with pytest.warns(UserWarning, match=kind):
        tout, tev = _port_group(hs, ws, QuantSpec(**SPEC))
    assert tev == jev and {e[2] for e in tev} == {kind}
    if fail == "undamped":
        assert tev[0][3] == {"mult": 1e-4}
    _assert_group_matches(jout, tout)


def test_expert_group_healthy_guarded_is_unguarded():
    hs, ws = _guard_inputs()
    spec = QuantSpec(**SPEC)
    guarded, ev = _port_group(hs, ws, spec)
    plain = tpl._solve_group_experts([torch.from_numpy(w) for w in ws],
                                     torch.from_numpy(hs), [spec] * 2,
                                     "comq_blocked")
    assert ev == []
    for (a, eb, ea, _), (b, eb2, ea2, _) in zip(guarded, plain):
        for k in ("codes", "scale", "z_lo"):
            assert torch.equal(a[k], b[k])
        assert float(eb) == float(eb2) and float(ea) == float(ea2)


# ---------------------------------------------------------------------------
# policies, checkpoints, fake quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve_method", ["rtn", "comq_blocked"])
def test_measure_bit_curves_moe_branch_matches_jax(jparams, curve_method):
    from repro.core.policy import measure_bit_curves as jax_curves
    from repro_torch.core.policy import measure_bit_curves
    tok = _tokens(0, (2, 48))
    jc, js = jax_curves(jparams[GRANITE], jax_cfg(GRANITE),
                        JPlan(remat=False), jnp.asarray(tok), JSpec(**SPEC),
                        curve_method=curve_method)
    with torch.no_grad():
        c, s = measure_bit_curves(params_from_numpy(jparams[GRANITE], "cpu"),
                                  get_smoke_config(GRANITE), BuildPlan(),
                                  torch.from_numpy(tok).long(),
                                  QuantSpec(**SPEC),
                                  curve_method=curve_method)
    assert s == js and list(c) == list(jc)
    assert s["0.moe.w_down"] == 4 * 32 * 64
    for name in jc:
        for b in jc[name]:
            np.testing.assert_allclose(c[name][b], jc[name][b],
                                       rtol=ERR_RTOL, err_msg=f"{name} {b}")


def test_port_expert_qpk_loads_in_jax_and_dequantizes_exactly(granite_runs,
                                                              tmp_path):
    from repro.ckpt.quantized import load_packed_ckpt as jax_load
    from repro.ckpt.quantized import unpack_tree as jax_unpack
    from repro.core.pipeline import dequant_qtensor as jax_dequant
    from repro_torch.ckpt import pack_tree, save_packed_ckpt
    from repro_torch.core.pipeline import dequant_qtensor, is_qtensor
    table = granite_runs[1]["__qlayers__"]
    path = str(tmp_path / "moe.qpk")
    save_packed_ckpt(path, pack_tree(table), arch=GRANITE, bits=4)
    jtable = jax_unpack(jax_load(path)["tree"])
    n = 0
    for layer, lp in table.items():
        for mod, leaves in lp.items():
            for leaf, node in leaves.items():
                jnode = jtable[layer][mod][leaf]
                if is_qtensor(node):
                    want = np.asarray(jax_dequant(jnode))
                    got = dequant_qtensor(node).numpy()
                    np.testing.assert_array_equal(got, want)
                    n += mod == "moe"
                else:
                    np.testing.assert_array_equal(np.asarray(jnode),
                                                  node.numpy())
    assert n == 3 * 2      # w_gate, w_up, w_down in each of 2 layers


def test_serving_params_keep_expert_codes_packed(granite_runs):
    """Expert leaves are not quant_matmul's layout: they stay packed in the
    serving params and the FFN dequantizes them, as in the JAX package;
    the attention projections go to quant_matmul."""
    from repro_torch.core.apply import (dequantize_qt_tree, qt_fusable,
                                        serving_params)
    from repro_torch.core.pipeline import materialize
    cfg = get_smoke_config(GRANITE).replace(compute_dtype="float32")
    sp = serving_params(granite_runs[1], cfg)
    lp = sp["layers"][0]
    assert lp["moe"]["w_gate"].cpb == 2
    assert tuple(lp["moe"]["w_gate"].codes.shape) == (4, 64, 16)
    assert not qt_fusable(lp["moe"]["w_up"]) and qt_fusable(lp["attn"]["wq"])
    kept = dequantize_qt_tree(lp, torch.float32, keep_fused=True)
    assert isinstance(kept["moe"]["w_down"], torch.Tensor)
    tok = torch.from_numpy(_tokens(3, (2, 12))).long()
    plan = BuildPlan(cache_dtype=torch.float32, prefill_cache_len=13)
    dense = materialize(granite_runs[1], cfg)
    with torch.no_grad():
        outs = []
        for params in (sp, dense):
            _, cache = tm.prefill(params, cfg, plan, tok)
            outs.append(tm.decode_step(params, cfg, plan, cache,
                                       tok[:, :1], 12)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-4)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_from_jax_packed_experts_matches_jax(granite_runs, cd):
    """JAX's quantize_model output (expert QTensors in the __qlayers__
    table) converted with qparams_from_numpy, served packed: prefill and
    teacher-forced decode logits as the JAX package's."""
    from repro.core.apply import serving_params as jax_serving
    from repro_torch.convert import qparams_from_numpy
    from repro_torch.core.apply import serving_params
    jqp = granite_runs[3]
    jc = jax_cfg(GRANITE).replace(compute_dtype=cd)
    tc = get_smoke_config(GRANITE).replace(compute_dtype=cd)
    tq = qparams_from_numpy(jax.device_get(jqp), "cpu")
    assert tuple(tq["__qlayers__"]["1"]["moe"]["w_up"]["codes"].shape) == \
        (4, 64, 32)
    jsp, tsp = jax_serving(jqp, jc), serving_params(tq, tc)
    prompt, steps = _tokens(3, (2, 16)), 4
    jplan = JPlan(remat=False, prefill_cache_len=16 + steps,
                  cache_dtype=jnp.dtype(cd))
    tplan = BuildPlan(prefill_cache_len=16 + steps,
                      cache_dtype=getattr(torch, cd))
    jl, jcache = jm.prefill(jsp, jc, jplan, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tcache = tm.prefill(tsp, tc, tplan,
                                torch.from_numpy(prompt).long())
        for i in range(steps + 1):
            assert_close(tl.float().numpy(), jl, cd, f"step {i}")
            if i == steps:
                break
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)  # teacher
            jl, jcache = jm.decode_step(jsp, jc, jplan, jcache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.int32(16 + i))
            tl, tcache = tm.decode_step(tsp, tc, tplan, tcache,
                                        torch.from_numpy(tok[:, None]).long(),
                                        16 + i)


def test_fake_quantize_params_covers_stacked_experts(jparams):
    from repro.core.apply import fake_quantize_params as jax_fake
    from repro_torch.core.apply import fake_quantize_params, is_qt
    cfg = get_smoke_config(GRANITE)
    fq = fake_quantize_params(params_from_numpy(jparams[GRANITE], "cpu"),
                              cfg, BuildPlan(), bits=4)
    jfq = jax_fake(jparams[GRANITE], jax_cfg(GRANITE), JPlan(remat=False),
                   bits=4)
    n = 0
    for l, lp in enumerate(fq["layers"]):
        assert not is_qt(lp["moe"]["router"])
        for leaf in ("w_gate", "w_up", "w_down"):
            q, j = lp["moe"][leaf], jfq["layers"]["moe"][leaf]
            assert q.shape == tuple(j.shape[1:]) and q.cpb == j.cpb
            np.testing.assert_array_equal(q.codes.numpy(),
                                          np.asarray(j.codes[l]))
            np.testing.assert_array_equal(q.scale.numpy(),
                                          np.asarray(j.scale[l]))
            np.testing.assert_array_equal(q.z_lo.numpy(),
                                          np.asarray(j.z_lo[l]))
            np.testing.assert_array_equal(
                q.dequant(torch.float32).numpy(),
                np.asarray(type(j)(j.codes[l], j.scale[l], j.z_lo[l],
                                   j.shape[1:], j.bits,
                                   cpb=j.cpb).dequant(jnp.float32)))
            n += 1
    assert n == 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SC = dict(max_slots=2, block_size=8, num_blocks=12, buckets=(8, 16, 32),
          max_blocks_per_slot=6)


def _staggered(rt, prompts, max_new=6):
    """Two up front, then one arrival per decode step; drained."""
    reqs = [rt.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for p in prompts[2:]:
        rt.step()
        reqs.append(rt.submit(p, max_new_tokens=max_new))
    rt.run()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_runtime_tokens_match_jax_mixed_staggered(jparams, kv_bits):
    from repro.serve import Runtime as JRuntime
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import Runtime, ServeConfig
    jcfg = jax_cfg(GRANITE).replace(compute_dtype="float32")
    cfg = get_smoke_config(GRANITE).replace(compute_dtype="float32")
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 259, (n,)).astype(np.int32)
               for n in (5, 16, 11, 8)]
    jrt = JRuntime(jparams[GRANITE], jcfg,
                   JPlan(remat=False, cache_dtype=jnp.float32,
                         kv_bits=kv_bits), JServeConfig(**SC))
    want = _staggered(jrt, prompts)
    params = params_from_numpy(jparams[GRANITE], "cpu")
    plan = BuildPlan(cache_dtype=torch.float32, kv_bits=kv_bits)
    with torch.no_grad():
        got = _staggered(Runtime(params, cfg, plan, ServeConfig(**SC),
                                 device="cpu"), prompts)
        solo_rt = Runtime(params, cfg, plan, ServeConfig(**SC), device="cpu")
        solo = [solo_rt.generate([p], max_new_tokens=6)[0].tolist()
                for p in prompts]
    assert got == want
    assert got == solo


def test_launchers_run_granite_smoke(capsys):
    from repro_torch.launch import quantize as launch_quantize
    from repro_torch.launch import serve as launch_serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_quantize.main(["--arch", GRANITE, "--smoke", "--method",
                              "comq_blocked", "--calib-batch", "2",
                              "--calib-seq", "48", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "granite-moe-3b-a800m-smoke"
    assert out["layers_quantized"] == 14
    assert out["comq_vs_rtn_error_improvement"] > 0.3
    assert abs(out["quant_loss"] - out["fp_loss"]) < 0.15
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launch_serve.main(["--arch", LLAMA4, "--smoke", "--quantize",
                           "--num-requests", "3", "--max-new", "4",
                           "--mixed", "--kv-bits", "4", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["packed_qt"] is True
    assert out["finish_reasons"] == ["length"] * 3
