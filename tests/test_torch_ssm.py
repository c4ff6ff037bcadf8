"""The port's hybrid family (hymba-1.5b smoke: 4/2 heads, window 16, a
parallel Mamba branch with N=4) against the JAX package, both on the JAX
init converted through numpy: the selective SSM (apply_ssm, its chunking
and state hand-off, decode_ssm), forward logits and every tap, decode
across the sliding window, quantize_model (staged and legacy) with the SSM
state carried from layer to layer as the JAX walk carries it, bit curves,
the .qpk exchange, fake quantization, the static Engine's greedy tokens,
and what the paged paths and launchers do for this family."""
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
from repro.core.apply import serving_params as jax_serving
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core import pipeline as tpl
from repro_torch.core.apply import serving_params
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
# per-leaf errors downstream of layer 0's first tap group: the bf16 taps
# differ by rounding between the frameworks (as tests/test_torch_pipeline)
ERR_RTOL = 0.05
# the selective SSM at f32: the same recurrence with other summation and
# scan orders (JAX's associative_scan tree vs the port's doubling scan)
SSM_RTOL = 1e-5


def _warnless(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 96 calibration tokens < d_ff
        return fn(*a, **k)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


def _tokens(seed, shape, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close_rel(got, want, rtol, what=""):
    """|got - want| <= rtol·|want| + rtol·max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the selective SSM
# ---------------------------------------------------------------------------

def _ssm_case(T, nonzero_state, seed=4):
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    p = jax.device_get(jssm.init_ssm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    st = jssm.init_ssm_state(2, cfg)
    if nonzero_state:
        st = jssm.SSMState(
            h=jnp.asarray(rng.standard_normal(st.h.shape), jnp.float32),
            conv=jnp.asarray(rng.standard_normal(st.conv.shape),
                             jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tst = tssm.SSMState(torch.from_numpy(np.array(st.h)),
                        torch.from_numpy(np.array(st.conv)))
    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    return cfg, tcfg, p, tp, x, st, tst


@pytest.mark.parametrize("T", [1, 16, 64])
@pytest.mark.parametrize("mode", ["nonzero_state", "multi_chunk"])
def test_apply_ssm_matches_jax(T, mode):
    """Outputs and final states within 1e-5 (f32), from a non-zero
    initial state, and with a chunk smaller than T (the state handed from
    chunk to chunk; T=1 is one chunk of one)."""
    cfg, tcfg, p, tp, x, st, tst = _ssm_case(T, mode == "nonzero_state")
    chunk = 1024 if mode == "nonzero_state" else max(1, T // 4)
    jy, jst = jssm.apply_ssm(p, jnp.asarray(x), cfg, st, chunk=chunk)
    with torch.no_grad():
        ty, tst2 = tssm.apply_ssm(tp, torch.from_numpy(x), tcfg, tst,
                                  chunk=chunk)
    _close_rel(ty.numpy(), jy, SSM_RTOL, "y")
    _close_rel(tst2.h.numpy(), jst.h, SSM_RTOL, "h")
    _close_rel(tst2.conv.numpy(), jst.conv, SSM_RTOL, "conv")
    assert tst2.h.dtype == torch.float32


def test_chunk_is_jax_s():
    """C = min(chunk, T), halved until it divides T: 1016 tokens run as one
    chunk, 1032 at chunk 1024 as 129 chunks of 8 — both the JAX split."""
    seen = []
    real = tssm._ssm_recurrence

    def spy(sel, xi, h0, *, cfg, chunk):
        seen.append(chunk)
        return real(sel, xi, h0, cfg=cfg, chunk=chunk)

    _, tcfg, _, tp, _, _, tst = _ssm_case(1, False)
    tssm._ssm_recurrence = spy
    try:
        with torch.no_grad():
            for T in (1016, 1032):
                x = torch.zeros(2, T, tcfg.d_model)
                tssm.apply_ssm(tp, x, tcfg, tst)
    finally:
        tssm._ssm_recurrence = real
    assert seen == [1016, 8]


def test_decode_ssm_steps_equal_one_apply():
    """decode_ssm stepped T times gives apply_ssm's outputs and state."""
    _, tcfg, _, tp, x, _, tst = _ssm_case(16, True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want, wst = tssm.apply_ssm(tp, xt, tcfg, tst)
        st, ys = tst, []
        for t in range(xt.shape[1]):
            y, st = tssm.decode_ssm(tp, xt[:, t:t + 1], tcfg, st)
            ys.append(y)
    _close_rel(torch.cat(ys, 1).numpy(), want.numpy(), SSM_RTOL, "y")
    _close_rel(st.h.numpy(), wst.h.numpy(), SSM_RTOL, "h")
    assert torch.equal(st.conv, wst.conv)


def test_init_ssm_shapes_and_constants_match_jax():
    cfg = get_smoke_config(ARCH)
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = jax.device_get(jssm.init_ssm(jax.random.PRNGKey(0), jax_cfg(ARCH)))
    assert sorted(p) == sorted(jp)
    for k in p:
        assert tuple(p[k].shape) == tuple(jp[k].shape), k
    for k in ("conv_b", "b_dt", "a_log", "d_skip"):
        np.testing.assert_allclose(p[k].numpy(), jp[k], rtol=1e-6)
    full = get_config(ARCH)
    assert tssm._dims(full) == (1600, 3200, 16, 100, 4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_and_taps_match_jax(jparams, cd):
    """Logits and every tap of layer 0, ssm_in and ssm_out_in included
    (f32 within 1e-4; bf16 under the dense test's bound)."""
    jc = jax_cfg(ARCH).replace(compute_dtype=cd)
    tc = get_smoke_config(ARCH).replace(compute_dtype=cd)
    tp = params_from_numpy(jparams, "cpu")
    tok = _tokens(1, (2, 24))
    jl = np.asarray(jm.forward(jparams, jc, JPlan(remat=False),
                               jnp.asarray(tok))[0], np.float32)
    with torch.no_grad():
        tl = tm.forward(tp, tc, BuildPlan(), torch.from_numpy(tok).long())[0]
    assert_close(tl.float().numpy(), jl, cd, "logits")

    jtaps, ttaps = {}, {}
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    jx = jm.embed_tokens(jparams, jc, JPlan(), jnp.asarray(tok))
    _, _, _, jst = jt.layer_full(lp0, jx, jc, JPlan(remat=False), False,
                                 ssm_state=jssm.init_ssm_state(2, jc),
                                 taps=jtaps)
    with torch.no_grad():
        tx = tm.embed_tokens(tp, tc, BuildPlan(), torch.from_numpy(tok))
        _, _, _, tst = tt.layer_full(
            tp["layers"][0], tx, tc, BuildPlan(), False, taps=ttaps,
            ssm_state=tssm.init_ssm_state(2, tc))
    assert list(ttaps) == list(jtaps)
    assert list(ttaps) == ["attn_in", "wo_in", "ssm_in", "ssm_out_in",
                           "mlp_in", "down_in"]
    for name in jtaps:
        assert tuple(ttaps[name].shape) == tuple(jtaps[name].shape), name
        assert_close(ttaps[name].float().numpy(), jtaps[name], cd, name)
    if cd == "float32":
        assert_close(tst.h.numpy(), jst.h, cd, "layer-0 state")


def test_forward_cache_holds_each_layers_state(jparams):
    """make_cache returns {"kv", "ssm"}: every layer's final state from a
    zero start, as JAX's prefill cache."""
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    tok = _tokens(2, (2, 12))
    _, _, jcache = jm.forward(jparams, jc, JPlan(remat=False),
                              jnp.asarray(tok), make_cache=True)
    with torch.no_grad():
        _, _, tcache = tm.forward(params_from_numpy(jparams, "cpu"), tc,
                                  BuildPlan(), torch.from_numpy(tok).long(),
                                  make_cache=True)
    assert set(tcache) == {"kv", "ssm"} and len(tcache["ssm"]) == 2
    for i, st in enumerate(tcache["ssm"]):
        assert_close(st.h.numpy(), np.asarray(jcache["ssm"].h[i]),
                     "float32", f"h{i}")
        assert_close(st.conv.numpy(), np.asarray(jcache["ssm"].conv[i]),
                     "float32", f"conv{i}")
    empty = tm.init_cache(tc, BuildPlan(), 2, 16, device="cpu")
    assert len(empty["ssm"]) == 2 and not bool(empty["ssm"][0].h.any())


@pytest.fixture(scope="module")
def jax_qparams(jparams):
    spec = JSpec(**SPEC)
    jq, _ = _warnless(jax_quantize, jparams, jax_cfg(ARCH),
                      JPlan(remat=False), jnp.asarray(_tokens(2, (2, 80))),
                      spec, method="rtn", guards=False)
    return jax.device_get(jq)


@pytest.mark.parametrize("weights", ["dense", "packed"])
def test_decode_across_the_window_matches_jax(jparams, jax_qparams,
                                              weights):
    """A 12-token prompt and 12 teacher-forced steps at f32 cross the smoke
    window of 16 on a 16-row ring cache: logits within 1e-4 of JAX, from
    the float weights and from packed codes (w_in / w_out dequantized each
    step, the attention and MLP projections through quant_matmul)."""
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    if weights == "dense":
        jp, tp = jparams, params_from_numpy(jparams, "cpu")
    else:
        jp = jax_serving(jax_qparams, jc)
        tp = serving_params(qparams_from_numpy(jax_qparams, "cpu"), tc)
        assert type(tp["layers"][0]["ssm"]["w_in"]).__name__ == "QT"
    jplan = JPlan(remat=False, cache_dtype=jnp.float32)
    tplan = BuildPlan(cache_dtype=torch.float32)
    prompt, steps = _tokens(3, (2, 12)), 12
    jl, jcache = jm.prefill(jp, jc, jplan, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tcache = tm.prefill(tp, tc, tplan, torch.from_numpy(prompt).long())
        assert tcache["kv"][0].k.shape[1] == 16
        for i in range(steps + 1):
            assert_close(tl.numpy(), jl, "float32", f"step {i}")
            if i == steps:
                break
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jcache = jm.decode_step(jp, jc, jplan, jcache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.int32(12 + i))
            tl, tcache = tm.decode_step(tp, tc, tplan, tcache,
                                        torch.from_numpy(tok[:, None]).long(),
                                        12 + i)
    for i, st in enumerate(tcache["ssm"]):
        assert_close(st.h.numpy(), np.asarray(jcache["ssm"].h[i]),
                     "float32", f"h{i}")


def test_param_count_matches_init_and_jax():
    from repro.configs import get_config as jax_full
    from repro.models.model import count_params_analytic
    cfg = get_smoke_config(ARCH)
    p = tm.init_params(cfg, seed=0, device="cpu")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert tm.param_count(cfg) == n == count_params_analytic(jax_cfg(ARCH))
    assert tm.param_count(get_config(ARCH)) == \
        count_params_analytic(jax_full(ARCH))


def test_family_checks():
    """The hybrid family runs; the paged paths refuse it as JAX's do;
    attention-free (here without rwkv), VLM-without-cross-attention and
    non-causal configs raise: the JAX configs define none of them."""
    cfg = get_smoke_config(ARCH)
    tt.check_ported(cfg)
    for change in (dict(attn_free=True), dict(family="vlm"),
                   dict(family="ssm", attn_free=True,
                        parallel_ssm_heads=False), dict(causal=False),
                   dict(parallel_ssm_heads=False), dict(ssm=None)):
        with pytest.raises(NotImplementedError, match="not a configuration"):
            tt.check_ported(cfg.replace(**change))
    with pytest.raises(NotImplementedError, match="paged decode"):
        tt.check_paged(cfg)
    tt.check_paged(get_smoke_config("qwen2-7b"))


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _leaves(table):
    return {f"{l}.{mod}.{leaf}": v for l, lp in table.items()
            for mod, leaves in lp.items() if isinstance(leaves, dict)
            for leaf, v in leaves.items() if tpl.is_qtensor(v)}


def _quantize_both(jparams, propagation, cd="bfloat16"):
    tok = _tokens(0, (2, 48))
    jq, jrep = _warnless(jax_quantize, jparams,
                         jax_cfg(ARCH).replace(compute_dtype=cd),
                         JPlan(remat=False), jnp.asarray(tok), JSpec(**SPEC),
                         method="comq_blocked", guards=False,
                         propagation=propagation)
    tq, trep = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                         get_smoke_config(ARCH).replace(compute_dtype=cd),
                         BuildPlan(), torch.from_numpy(tok).long(),
                         QuantSpec(**SPEC), method="comq_blocked",
                         propagation=propagation)
    return jax.device_get(jq), jrep, tq, trep


@pytest.fixture(scope="module")
def staged(jparams):
    return _quantize_both(jparams, "staged")


@pytest.mark.parametrize("propagation", ["staged", "legacy"])
def test_quantize_matches_jax(jparams, staged, propagation):
    """Layer 0's codes equal JAX's where both solve the same Gram (the
    attn_in group and w_in, whose tap ssm_in is the same normed input);
    every leaf's errors within ERR_RTOL; improvement > 0 over RTN."""
    jq, jrep, tq, trep = (staged if propagation == "staged"
                          else _quantize_both(jparams, "legacy"))
    jl, tl = _leaves(jq["__qlayers__"]), _leaves(tq["__qlayers__"])
    assert jl.keys() == tl.keys() and len(tl) == 2 * 9
    for k in ("0.attn.wq", "0.attn.wk", "0.attn.wv", "0.ssm.w_in"):
        np.testing.assert_array_equal(tl[k]["codes"].numpy(),
                                      np.asarray(jl[k]["codes"]), err_msg=k)
        np.testing.assert_allclose(tl[k]["scale"].numpy(),
                                   np.asarray(jl[k]["scale"]), rtol=1e-5,
                                   err_msg=k)
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    # staged: tap order within the forward; legacy: the tap map's order
    mid = (["ssm.w_in", "ssm.w_out", "mlp.w_gate", "mlp.w_up"]
           if propagation == "staged" else
           ["mlp.w_gate", "mlp.w_up", "mlp.w_down", "ssm.w_in"])
    assert [r.name for r in trep.layers[:8]] == [
        "attn.wq", "attn.wk", "attn.wv", "attn.wo"] + mid
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    assert trep.total_improvement() > 0 and not trep.guard_events


def _layer_states(monkeypatch, module, attr, out):
    """Record the SSM state each layer_full call of a quantize walk starts
    from (the JAX walk calls `layer_full` with it as a keyword)."""
    real = getattr(module, attr)

    def spy(*a, **k):
        st = k.get("ssm_state")
        out.append(None if st is None else np.array(st.h, np.float32))
        return real(*a, **k)

    monkeypatch.setattr(module, attr, spy)


def test_walk_carries_the_ssm_state_across_layers_as_jax(jparams,
                                                         monkeypatch):
    """The JAX calibration walk starts layer l+1 from layer l's final SSM
    state (forward starts every layer from zeros). The port's walk does
    the same: at f32 the state layer 1 starts from equals JAX's and is not
    zero, and a walk restarted from zeros at every layer gives other
    layer-1 SSM codes and errors."""
    jst, tst = [], []
    _layer_states(monkeypatch, jpl.tfm, "layer_full", jst)
    _layer_states(monkeypatch, tpl.tfm, "layer_full", tst)
    _, jrep, tq, trep = _quantize_both(jparams, "staged", cd="float32")
    monkeypatch.undo()
    assert len(jst) == len(tst) == 2
    assert not jst[0].any() and tst[0] is None     # the zero state
    assert np.abs(tst[1]).max() > 1e-3
    _close_rel(tst[1], jst[1], 1e-4, "layer-1 initial state")

    real = tpl.layer_with_state

    def zero_start(lp, x, state, cfg, plan, **kw):
        return real(lp, x, None, cfg, plan, **kw)

    monkeypatch.setattr(tpl, "layer_with_state", zero_start)
    tz, zrep = _warnless(quantize_model,
                         params_from_numpy(jparams, "cpu"),
                         get_smoke_config(ARCH).replace(
                             compute_dtype="float32"),
                         BuildPlan(), torch.from_numpy(_tokens(0, (2, 48))
                                                       ).long(),
                         QuantSpec(**SPEC), method="comq_blocked")
    a = tq["__qlayers__"]["1"]["ssm"]["w_out"]["codes"]
    b = tz["__qlayers__"]["1"]["ssm"]["w_out"]["codes"]
    assert not torch.equal(a, b)
    err = {r.name: r.err_after for r in trep.layers if r.layer == 1}
    zerr = {r.name: r.err_after for r in zrep.layers if r.layer == 1}
    jerr = {r.name: r.err_after for r in jrep.layers if r.layer == 1}
    assert zerr["ssm.w_out"] != err["ssm.w_out"]
    np.testing.assert_allclose(err["ssm.w_out"], jerr["ssm.w_out"],
                               rtol=1e-3)
    # layer 0 is the same walk either way
    assert torch.equal(tq["__qlayers__"]["0"]["ssm"]["w_out"]["codes"],
                       tz["__qlayers__"]["0"]["ssm"]["w_out"]["codes"])


def test_smoke_quantize_improves_and_keeps_the_loss():
    """The JAX `test_pipeline_improves_over_rtn_and_preserves_loss` gate on
    the port's own init: improvement over RTN, loss gap <= 0.35."""
    from repro_torch.launch.quantize import quantize_and_eval
    run = _warnless(quantize_and_eval, get_smoke_config(ARCH),
                    method="comq_blocked", calib_batch=2, calib_seq=48,
                    device="cpu")
    s = run.summary
    assert s["comq_vs_rtn_error_improvement"] > 0
    assert abs(s["quant_loss"] - s["fp_loss"]) <= 0.35
    assert s["layers_quantized"] == 18 and s["guard_events"] == 0


@pytest.mark.parametrize("curve_method", ["rtn", "comq_blocked"])
def test_measure_bit_curves_ssm_branch_matches_jax(jparams, curve_method):
    from repro.core.policy import measure_bit_curves as jax_curves
    from repro_torch.core.policy import measure_bit_curves
    tok = _tokens(0, (2, 48))
    jc, js = jax_curves(jparams, jax_cfg(ARCH), JPlan(remat=False),
                        jnp.asarray(tok), JSpec(**SPEC),
                        curve_method=curve_method)
    with torch.no_grad():
        c, s = measure_bit_curves(params_from_numpy(jparams, "cpu"),
                                  get_smoke_config(ARCH), BuildPlan(),
                                  torch.from_numpy(tok).long(),
                                  QuantSpec(**SPEC),
                                  curve_method=curve_method)
    assert s == js and list(c) == list(jc)
    assert s["1.ssm.w_in"] == 64 * 256 and s["1.ssm.w_out"] == 128 * 64
    for name in jc:
        for b in jc[name]:
            np.testing.assert_allclose(c[name][b], jc[name][b],
                                       rtol=ERR_RTOL, err_msg=f"{name} {b}")


def test_port_qpk_loads_in_jax_with_the_ssm_leaves(staged, tmp_path):
    """The packed table carries w_in / w_out as codes and the SSM's dense
    leaves (conv, x-projection, dt, A, D) unchanged; the JAX reader
    dequantizes the codes exactly and reads the dense leaves bit for bit."""
    from repro.ckpt.quantized import load_packed_ckpt as jax_load
    from repro.ckpt.quantized import unpack_tree as jax_unpack
    from repro.core.pipeline import dequant_qtensor as jax_dequant
    from repro_torch.ckpt import pack_tree, save_packed_ckpt
    table = staged[2]["__qlayers__"]
    path = str(tmp_path / "hymba.qpk")
    save_packed_ckpt(path, pack_tree(table), arch=ARCH, bits=4)
    jtable = jax_unpack(jax_load(path)["tree"])
    seen = set()
    for layer, lp in table.items():
        for leaf, node in lp["ssm"].items():
            jnode = jtable[layer]["ssm"][leaf]
            if tpl.is_qtensor(node):
                np.testing.assert_array_equal(
                    tpl.dequant_qtensor(node).numpy(),
                    np.asarray(jax_dequant(jnode)))
            else:
                np.testing.assert_array_equal(np.asarray(jnode),
                                              node.numpy())
            seen.add((leaf, tpl.is_qtensor(node)))
    assert seen == {("w_in", True), ("w_out", True), ("conv_w", False),
                    ("conv_b", False), ("w_xproj", False), ("w_dt", False),
                    ("b_dt", False), ("a_log", False), ("d_skip", False)}


def test_fake_quantize_params_wraps_the_ssm_leaves_as_jax(jparams):
    from repro.core.apply import fake_quantize_params as jax_fake
    from repro_torch.core.apply import fake_quantize_params, is_qt
    cfg = get_smoke_config(ARCH)
    jf = jax_fake(jparams, jax_cfg(ARCH), JPlan(remat=False), bits=4)
    tf = fake_quantize_params(params_from_numpy(jparams, "cpu"), cfg,
                              BuildPlan(), bits=4)
    for leaf in ("w_in", "w_out", "w_xproj"):
        got = tf["layers"][1]["ssm"][leaf]
        assert is_qt(got), leaf
        want = jf["layers"]["ssm"][leaf].dequant(jnp.float32)[1]
        np.testing.assert_allclose(got.dequant(torch.float32).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=leaf)
    assert not is_qt(tf["layers"][0]["ssm"]["w_dt"])   # (100, 3200) at full


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_equal_jax(jax_qparams):
    """The static Engine from packed codes at f32: the same greedy tokens
    as the JAX Engine, 8 steps past a 12-token prompt (across the window)."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.serve import Engine
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    prompts = _tokens(6, (3, 12))
    want = JEngine(jax_serving(jax_qparams, jc), jc,
                   JPlan(remat=False, cache_dtype=jnp.float32),
                   max_len=20).generate_batch(prompts, max_new_tokens=8)
    with torch.no_grad():
        got = Engine(serving_params(qparams_from_numpy(jax_qparams, "cpu"),
                                    tc), tc,
                     BuildPlan(cache_dtype=torch.float32), max_len=20,
                     device="cpu").generate_batch(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_runtime_and_decode_refuse_hymba_as_jax():
    from repro.serve import Runtime as JRuntime
    from repro_torch.serve import Runtime, ServeConfig
    jc, tc = jax_cfg(ARCH), get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="paged"):
        JRuntime(None, jc, JPlan())
    with pytest.raises(NotImplementedError, match="paged"):
        Runtime(None, tc, BuildPlan(), ServeConfig(), device="cpu")
    p = tm.init_params(tc, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        tm.decode_step_paged(p, tc, BuildPlan(), {}, None, None, None)


def test_serve_launcher_switches_hymba_to_the_static_engine(capsys):
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--engine", "paged",
                             "--num-requests", "2", "--prompt-len", "12",
                             "--max-new", "6", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "note: hybrid/attention-free archs use the dense-cache static " \
        "engine" in text
    assert out["engine"] == "static" and out["new_tokens"] == 12
    assert json.loads(text.strip().splitlines()[-1])["engine"] == "static"


@pytest.mark.parametrize("flags", [
    [], ["--policy", "*.w_out=8,kv=8"], ["--bits-budget", "3.5"],
    ["--propagation", "legacy", "--no-guards"]])
def test_quantize_launcher_runs_hymba(flags, capsys):
    from repro_torch.launch import quantize as launch_quantize
    s = _warnless(launch_quantize.main,
                  ["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                   "--calib-batch", "2", "--calib-seq", "48", "--device",
                   "cpu"] + flags)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
    assert s["arch"] == "hymba-1.5b-smoke" and s["layers_quantized"] == 18
    assert s["comq_vs_rtn_error_improvement"] > 0
    assert s["mixed_policy"] == bool(flags and flags[0] in ("--policy",
                                                             "--bits-budget"))
