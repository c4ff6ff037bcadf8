"""The port's attention-free family (rwkv6-7b smoke: 2 layers, d 64, 4 wkv
heads of 16, layernorm) against the JAX package, both on the JAX init
converted through numpy: layernorm, the chunked wkv recurrence (C = 16
and C = 1, from a non-zero state, against JAX and a step-by-step
reference), time-mix and channel-mix, forward logits and every tap,
prefill plus decode against forward and JAX, quantize_model (staged and
legacy) with the RWKV state carried from layer to layer as the JAX walk
carries it, bit curves, the .qpk exchange, fake quantization, the static
Engine's greedy tokens, and what the paged paths and launchers do for
this family."""
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
from repro.models import common as jcommon
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import rwkv as jrwkv
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core import pipeline as tpl
from repro_torch.core.apply import serving_params
from repro_torch.models import BuildPlan
from repro_torch.models import common as tcommon
from repro_torch.models import model as tm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
# per-leaf errors downstream of layer 0's first tap group: the bf16 taps
# differ by rounding between the frameworks (as tests/test_torch_pipeline)
ERR_RTOL = 0.05
# the wkv and the mixes at f32: the same math in other summation orders
WKV_RTOL = 1e-5
# the chunked wkv against the step-by-step recurrence (f64)
STEP_RTOL = 1e-4
LN_TOL = 1e-6
TAPS = ["tm_r_in", "tm_k_in", "tm_v_in", "tm_g_in", "tm_o_in", "cm_k_in",
        "cm_r_in", "cm_v_in"]


def _warnless(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close_rel(got, want, rtol, what=""):
    """|got - want| <= rtol·|want| + rtol·max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _cfgs(cd="float32"):
    return (jax_cfg(ARCH).replace(compute_dtype=cd),
            get_smoke_config(ARCH).replace(compute_dtype=cd))


# ---------------------------------------------------------------------------
# layernorm and the wkv recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """f32 inside with the biased variance (torch.var's default is the
    unbiased one), cast back: within 1e-6 of JAX at f32, and the same bf16
    values."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jcommon.layernorm(jx, jnp.asarray(w), jnp.asarray(b),
                                        1e-5).astype(jnp.float32))
    got = tcommon.layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=LN_TOL,
                                   atol=LN_TOL)
    else:
        err = np.abs(got.float().numpy() - want)
        assert err.max() <= 2 ** -6 * (np.abs(want).max()), err.max()
    cfg = get_smoke_config(ARCH)
    p = tcommon.norm_params(cfg, "cpu")
    assert sorted(p) == ["bias", "scale"] and not bool(p["bias"].any())
    assert sorted(tcommon.norm_params(get_smoke_config("qwen2-7b"),
                                      "cpu")) == ["scale"]


def _wkv_inputs(T, seed=3):
    B, H, hd = 2, 4, 16
    rng = np.random.default_rng(seed + T)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.uniform(-8.0, 1.61, (B, T, H, hd))), -5.0,
                   -1e-6).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


def _wkv_steps(r, k, v, logw, u, s0):
    """S_t = diag(w_t)·S_{t-1} + k_tᵀv_t, o_t = r_t·(diag(u)·k_tᵀv_t +
    S_{t-1}), one token at a time in f64."""
    r, k, v, w, u, s = (np.asarray(a, np.float64) for a in
                        (r, k, v, np.exp(logw), u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,hd,hd)
        outs.append(np.einsum("bhk,bhkv->bhv", r[:, t],
                              u[None, :, :, None] * kv + s))
        s = w[:, t, :, :, None] * s + kv
    return np.stack(outs, 1), s


@pytest.mark.parametrize("C,T", [(16, 32), (1, 5)])
def test_wkv_matches_jax_and_the_step_recurrence(C, T):
    """_wkv_chunk (one chunk of C) and _wkv_scan (T tokens in chunks of
    C, the state handed from chunk to chunk) from a non-zero state: within
    1e-5 of JAX, and 1e-4 of the step-by-step recurrence."""
    args = _wkv_inputs(T)
    targs = [torch.from_numpy(a) for a in args]
    # r, k, v, logw cut to one chunk; u and s0 as they are
    jo, js = jrwkv._wkv_chunk(*(jnp.asarray(a[:, :C]) for a in args[:4]),
                              *(jnp.asarray(a) for a in args[4:]))
    to, ts = trwkv._wkv_chunk(*(a[:, :C] for a in targs[:4]), *targs[4:])
    _close_rel(to.numpy(), jo, WKV_RTOL, "chunk out")
    _close_rel(ts.numpy(), js, WKV_RTOL, "chunk state")

    jo, js = jrwkv._wkv_scan(*(jnp.asarray(a) for a in args), chunk=C)
    to, ts = trwkv._wkv_scan(*targs, chunk=C)
    assert tuple(to.shape) == (2, T, 64) and to.dtype == torch.float32
    _close_rel(to.numpy(), jo, WKV_RTOL, "scan out")
    _close_rel(ts.numpy(), js, WKV_RTOL, "scan state")
    want_o, want_s = _wkv_steps(*args)
    _close_rel(to.numpy(), want_o.reshape(2, T, 64), STEP_RTOL, "vs steps")
    _close_rel(ts.numpy(), want_s, STEP_RTOL, "state vs steps")


def test_chunk_rule_is_jax_s(monkeypatch):
    """C = 16 when 16 divides T (T >= 16), else 1: 32 and 16 tokens in
    chunks of 16; 24, 8 and 1 token in chunks of 1."""
    seen = []
    real = trwkv._wkv_scan

    def spy(*a, chunk):
        seen.append(chunk)
        return real(*a, chunk=chunk)

    monkeypatch.setattr(trwkv, "_wkv_scan", spy)
    jc, tc = _cfgs()
    p = _time_mix_params(jc)[1]
    with torch.no_grad():
        for T in (32, 16, 24, 8, 1):
            st = trwkv.init_rwkv_state(2, tc)
            trwkv.apply_time_mix(p, torch.zeros(2, T, 64), tc, st)
    assert seen == [16, 16, 1, 1, 1]


def _time_mix_params(jc, seed=5):
    p = jax.device_get(jrwkv.init_time_mix(jax.random.PRNGKey(seed), jc))
    # non-trivial mixes, decay and bonus (the init has constants there)
    rng = np.random.default_rng(seed)
    p = {k: (v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
             if k in ("mu_base", "mu_rkvwg", "w0_decay", "u_bonus", "ln_w")
             else v) for k, v in p.items()}
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _state(B, d, H, hd, seed):
    rng = np.random.default_rng(seed)
    x_tm, x_cm = (rng.standard_normal((B, 1, d)).astype(np.float32)
                  for _ in range(2))
    s = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return (jrwkv.RWKVState(*(jnp.asarray(a) for a in (x_tm, x_cm, s))),
            trwkv.RWKVState(*(torch.from_numpy(a) for a in (x_tm, x_cm, s))))


@pytest.mark.parametrize("T", [1, 32])
def test_time_and_channel_mix_match_jax(T):
    """apply_time_mix and apply_channel_mix from a non-zero state at f32:
    outputs, taps and new states within 1e-5 of JAX; the new shifts are
    the input's last row."""
    jc, tc = _cfgs()
    jp, tp = _time_mix_params(jc)
    js, ts = _state(2, 64, 4, 16, seed=T)
    x = np.random.default_rng(T).standard_normal((2, T, 64)).astype(
        np.float32)
    jtaps, ttaps = {}, {}
    jo, jx, jst = jrwkv.apply_time_mix(jp, jnp.asarray(x), jc, js, taps=jtaps)
    with torch.no_grad():
        to, tx, tst = trwkv.apply_time_mix(tp, torch.from_numpy(x), tc, ts,
                                           taps=ttaps)
    _close_rel(to.numpy(), jo, WKV_RTOL, "time-mix out")
    _close_rel(tst.numpy(), jst, WKV_RTOL, "wkv state")
    assert torch.equal(tx, torch.from_numpy(x[:, -1:]))
    assert list(ttaps) == list(jtaps) == TAPS[:4] + ["tm_o_in"]
    for name in jtaps:
        _close_rel(ttaps[name].numpy(), jtaps[name], WKV_RTOL, name)

    jcm = jax.device_get(jrwkv.init_channel_mix(jax.random.PRNGKey(6), jc))
    tcm = {k: torch.from_numpy(np.array(v)) for k, v in jcm.items()}
    jtaps, ttaps = {}, {}
    jo, jx = jrwkv.apply_channel_mix(jcm, jnp.asarray(x), jc, js.x_cm,
                                     taps=jtaps)
    with torch.no_grad():
        to, tx = trwkv.apply_channel_mix(tcm, torch.from_numpy(x), tc,
                                         ts.x_cm, taps=ttaps)
    _close_rel(to.numpy(), jo, WKV_RTOL, "channel-mix out")
    assert torch.equal(tx, torch.from_numpy(x[:, -1:]))
    assert list(ttaps) == list(jtaps) == TAPS[5:]
    for name in jtaps:
        _close_rel(ttaps[name].numpy(), jtaps[name], WKV_RTOL, name)


def test_init_shapes_and_constants_match_jax():
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    jc = jax_cfg(ARCH)
    for tinit, jinit in ((trwkv.init_time_mix, jrwkv.init_time_mix),
                         (trwkv.init_channel_mix, jrwkv.init_channel_mix)):
        p = tinit(gen, cfg, "cpu")
        jp = jax.device_get(jinit(jax.random.PRNGKey(0), jc))
        assert sorted(p) == sorted(jp)
        for k in p:
            assert tuple(p[k].shape) == tuple(jp[k].shape), k
            if k.startswith(("mu", "w0", "u_", "ln")):
                np.testing.assert_array_equal(p[k].numpy(), jp[k], k)
    assert trwkv._dims(get_config(ARCH)) == (4096, 64, 64)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_convert_slices_the_rwkv_stacks(jparams):
    """The JAX (L, ...) stacks, (L, 5, lora, d) w2_ts among them, become
    per-layer leaves with the same values."""
    tp = params_from_numpy(jparams, "cpu")
    assert len(tp["layers"]) == 2
    for i in range(2):
        for mod in ("tm", "cm", "ln1", "ln2"):
            for k, v in jparams["layers"][mod].items():
                np.testing.assert_array_equal(tp["layers"][i][mod][k].numpy(),
                                              v[i], f"{i}.{mod}.{k}")
    assert tuple(tp["layers"][1]["tm"]["w2_ts"].shape) == (5, 4, 64)
    assert sorted(tp["final_norm"]) == ["bias", "scale"]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_and_taps_match_jax(jparams, cd):
    """Logits (f32 within 1e-4; bf16 under the dense test's bound) and
    every tap of layer 0 (f32 within 1e-5), and layer 0's new state."""
    jc, tc = _cfgs(cd)
    tp = params_from_numpy(jparams, "cpu")
    tok = _tokens(1, (2, 32))
    jl = np.asarray(jm.forward(jparams, jc, JPlan(remat=False),
                               jnp.asarray(tok))[0], np.float32)
    with torch.no_grad():
        tl = tm.forward(tp, tc, BuildPlan(), torch.from_numpy(tok).long())[0]
    assert_close(tl.float().numpy(), jl, cd, "logits")

    jtaps, ttaps = {}, {}
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    jx = jm.embed_tokens(jparams, jc, JPlan(), jnp.asarray(tok))
    _, _, _, jst = jt.layer_full(lp0, jx, jc, JPlan(remat=False), False,
                                 rwkv_state=jrwkv.init_rwkv_state(2, jc),
                                 taps=jtaps)
    with torch.no_grad():
        tx = tm.embed_tokens(tp, tc, BuildPlan(), torch.from_numpy(tok))
        _, cache, aux, tst = tt.layer_full(tp["layers"][0], tx, tc,
                                           BuildPlan(), True, taps=ttaps)
    assert cache is None and aux is None
    assert list(ttaps) == list(jtaps) == TAPS
    for name in jtaps:
        assert tuple(ttaps[name].shape) == tuple(jtaps[name].shape), name
        if cd == "float32":
            _close_rel(ttaps[name].numpy(), jtaps[name], WKV_RTOL, name)
        else:
            assert_close(ttaps[name].float().numpy(), jtaps[name], cd, name)
    if cd == "float32":
        for a, b, name in zip(tst, jst, ("x_tm", "x_cm", "s")):
            _close_rel(a.numpy(), b, WKV_RTOL, f"layer-0 {name}")


def test_forward_cache_holds_each_layers_state(jparams):
    """make_cache returns {"rwkv"} alone: every layer's final state from a
    zero start, as JAX's prefill cache."""
    jc, tc = _cfgs()
    tok = _tokens(2, (2, 16))
    _, _, jcache = jm.forward(jparams, jc, JPlan(remat=False),
                              jnp.asarray(tok), make_cache=True)
    with torch.no_grad():
        _, _, tcache = tm.forward(params_from_numpy(jparams, "cpu"), tc,
                                  BuildPlan(), torch.from_numpy(tok).long(),
                                  make_cache=True)
    assert set(tcache) == set(jcache) == {"rwkv"}
    assert len(tcache["rwkv"]) == 2
    for i, st in enumerate(tcache["rwkv"]):
        for a, name in zip(st, ("x_tm", "x_cm", "s")):
            assert_close(a.numpy(), np.asarray(getattr(jcache["rwkv"],
                                                       name)[i]),
                         "float32", f"{name}{i}")
    empty = tm.init_cache(tc, BuildPlan(), 2, 16, device="cpu")
    assert set(empty) == {"rwkv"} and len(empty["rwkv"]) == 2
    assert not any(bool(a.any()) for st in empty["rwkv"] for a in st)


@pytest.fixture(scope="module")
def jax_qparams(jparams):
    jq, _ = _warnless(jax_quantize, jparams, jax_cfg(ARCH),
                      JPlan(remat=False), jnp.asarray(_tokens(2, (2, 80))),
                      JSpec(**SPEC), method="rtn", guards=False)
    return jax.device_get(jq)


def test_prefill_plus_decode_equals_forward(jparams):
    """Prefill of 32 tokens (chunks of 16) and 8 teacher-forced decode steps
    (chunks of 1) give the logits of one forward over the 40 tokens, and
    a 24-token prompt (chunks of 1 in prefill) those of its forward."""
    _, tc = _cfgs()
    tp = params_from_numpy(jparams, "cpu")
    for T, steps in ((32, 8), (24, 4)):
        tok = torch.from_numpy(_tokens(4, (2, T + steps))).long()
        with torch.no_grad():
            want = tm.forward(tp, tc, BuildPlan(), tok)[0]
            tl, cache = tm.prefill(tp, tc, BuildPlan(), tok[:, :T])
            got = [tl]
            for i in range(steps):
                tl, cache = tm.decode_step(tp, tc, BuildPlan(), cache,
                                           tok[:, T + i:T + i + 1], T + i)
                got.append(tl)
        _close_rel(torch.stack(got[:-1], 1).numpy(),
                   want[:, T - 1:T + steps - 1].numpy(), 1e-4,
                   f"T={T}")


@pytest.mark.parametrize("weights", ["dense", "packed"])
def test_decode_matches_jax(jparams, jax_qparams, weights):
    """A 16-token prompt and 8 teacher-forced steps at f32: logits within
    1e-4 of JAX and the final states, from the float weights and from
    packed codes (every RWKV projection dequantized each step, as in
    JAX)."""
    jc, tc = _cfgs()
    if weights == "dense":
        jp, tp = jparams, params_from_numpy(jparams, "cpu")
    else:
        jp = jax_serving(jax_qparams, jc)
        tp = serving_params(qparams_from_numpy(jax_qparams, "cpu"), tc)
        assert type(tp["layers"][0]["cm"]["w_v"]).__name__ == "QT"
    jplan, tplan = JPlan(remat=False), BuildPlan()
    prompt, steps = _tokens(3, (2, 16)), 8
    jl, jcache = jm.prefill(jp, jc, jplan, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tcache = tm.prefill(tp, tc, tplan, torch.from_numpy(prompt).long())
        for i in range(steps + 1):
            assert_close(tl.numpy(), jl, "float32", f"step {i}")
            if i == steps:
                break
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jcache = jm.decode_step(jp, jc, jplan, jcache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.int32(16 + i))
            tl, tcache = tm.decode_step(tp, tc, tplan, tcache,
                                        torch.from_numpy(tok[:, None]).long(),
                                        16 + i)
    assert set(tcache) == {"rwkv"}
    for i, st in enumerate(tcache["rwkv"]):
        assert_close(st.s.numpy(), np.asarray(jcache["rwkv"].s[i]),
                     "float32", f"s{i}")


@pytest.mark.parametrize("arch", [ARCH, "musicgen-large"])
def test_param_count_matches_init_and_jax(arch):
    from repro.configs import get_config as jax_full
    from repro.models.model import count_params
    cfg = get_smoke_config(arch)
    p = tm.init_params(cfg, seed=0, device="cpu")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert tm.param_count(cfg) == n == count_params(jax_cfg(arch))
    assert tm.param_count(get_config(arch)) == count_params(jax_full(arch))


def test_family_checks():
    """The RWKV family runs; the paged paths refuse it as JAX's do; a VLM
    without cross-attention, an attention-free encoder, non-causal RWKV
    and attention-free-without-rwkv configs raise: the JAX configs define
    none of them."""
    cfg = get_smoke_config(ARCH)
    tt.check_ported(cfg)
    for change in (dict(rwkv=None), dict(family="vlm"),
                   dict(family="encoder", causal=False), dict(causal=False),
                   dict(attn_free=False), dict(norm_type="groupnorm")):
        with pytest.raises(NotImplementedError, match="not a configuration"):
            tt.check_ported(cfg.replace(**change))
    with pytest.raises(NotImplementedError, match="paged decode"):
        tt.check_paged(cfg)


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
    """Layer 0's first group (tm.w_r on tm_r_in) has JAX's codes, bit for
    bit; every leaf's errors within ERR_RTOL; improvement > 0 over RTN."""
    jq, jrep, tq, trep = (staged if propagation == "staged"
                          else _quantize_both(jparams, "legacy"))
    jl, tl = _leaves(jq["__qlayers__"]), _leaves(tq["__qlayers__"])
    assert jl.keys() == tl.keys() and len(tl) == 2 * 8
    k = "0.tm.w_r"
    np.testing.assert_array_equal(tl[k]["codes"].numpy(),
                                  np.asarray(jl[k]["codes"]), err_msg=k)
    np.testing.assert_allclose(tl[k]["scale"].numpy(),
                               np.asarray(jl[k]["scale"]), rtol=1e-5,
                               err_msg=k)
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    assert [r.name for r in trep.layers[:8]] == [
        "tm.w_r", "tm.w_k", "tm.w_v", "tm.w_g", "tm.w_o", "cm.w_k", "cm.w_r",
        "cm.w_v"]
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    assert trep.total_improvement() > 0 and not trep.guard_events


def _layer_states(monkeypatch, module, attr, out):
    """Record the RWKV state each layer_full call of a quantize walk starts
    from (the JAX walk calls `layer_full` with it as a keyword)."""
    real = getattr(module, attr)

    def spy(*a, **k):
        st = k.get("rwkv_state")
        out.append(None if st is None else
                   [np.array(t, np.float32) for t in st])
        return real(*a, **k)

    monkeypatch.setattr(module, attr, spy)


def test_walk_carries_the_rwkv_state_across_layers_as_jax(jparams,
                                                          monkeypatch):
    """The JAX calibration walk starts layer l+1 from layer l's final
    (x_tm, x_cm, s) (forward starts every layer from zeros). The port's
    walk does the same: at f32 the state layer 1 starts from equals JAX's
    and is not zero, and a walk restarted from zeros at every layer gives
    other layer-1 codes and errors."""
    jst, tst = [], []
    _layer_states(monkeypatch, jpl.tfm, "layer_full", jst)
    _layer_states(monkeypatch, tpl.tfm, "layer_full", tst)
    _, jrep, tq, trep = _quantize_both(jparams, "staged", cd="float32")
    monkeypatch.undo()
    assert len(jst) == len(tst) == 2
    assert not any(a.any() for a in jst[0]) and tst[0] is None
    for a, b, name in zip(tst[1], jst[1], ("x_tm", "x_cm", "s")):
        assert np.abs(a).max() > 1e-3, name
        _close_rel(a, b, 1e-4, f"layer-1 initial {name}")

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
    a = tq["__qlayers__"]["1"]["tm"]["w_o"]["codes"]
    b = tz["__qlayers__"]["1"]["tm"]["w_o"]["codes"]
    assert not torch.equal(a, b)
    err = {r.name: r.err_after for r in trep.layers if r.layer == 1}
    zerr = {r.name: r.err_after for r in zrep.layers if r.layer == 1}
    jerr = {r.name: r.err_after for r in jrep.layers if r.layer == 1}
    assert zerr["tm.w_o"] != err["tm.w_o"]
    np.testing.assert_allclose(err["tm.w_o"], jerr["tm.w_o"], rtol=1e-3)
    assert torch.equal(tq["__qlayers__"]["0"]["tm"]["w_o"]["codes"],
                       tz["__qlayers__"]["0"]["tm"]["w_o"]["codes"])


@pytest.mark.parametrize("curve_method", ["rtn", "comq_blocked"])
def test_measure_bit_curves_rwkv_branch_matches_jax(jparams, curve_method):
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
    assert s == js and list(c) == list(jc) and len(c) == 16
    assert s["1.cm.w_v"] == 128 * 64 and s["1.tm.w_g"] == 64 * 64
    for name in jc:
        for b in jc[name]:
            np.testing.assert_allclose(c[name][b], jc[name][b],
                                       rtol=ERR_RTOL, err_msg=f"{name} {b}")


def test_port_qpk_loads_in_jax_with_the_rwkv_leaves(staged, tmp_path):
    """The packed table carries the eight projections as codes and the
    mixes, LoRAs, decay and bonus unchanged; the JAX reader dequantizes
    the codes exactly and reads the dense leaves bit for bit; the port's
    serving_params packs the same leaves as QT."""
    from repro.ckpt.quantized import load_packed_ckpt as jax_load
    from repro.ckpt.quantized import unpack_tree as jax_unpack
    from repro.core.pipeline import dequant_qtensor as jax_dequant
    from repro_torch.ckpt import pack_tree, save_packed_ckpt, unpack_tree
    from repro_torch.core.apply import is_qt
    tq = staged[2]
    table = tq["__qlayers__"]
    path = str(tmp_path / "rwkv.qpk")
    save_packed_ckpt(path, pack_tree(table), arch=ARCH, bits=4)
    jtable = jax_unpack(jax_load(path)["tree"])
    back = unpack_tree(pack_tree(table))
    seen = set()
    for layer, lp in table.items():
        for mod in ("tm", "cm"):
            for leaf, node in lp[mod].items():
                jnode = jtable[layer][mod][leaf]
                if tpl.is_qtensor(node):
                    np.testing.assert_array_equal(
                        tpl.dequant_qtensor(node).numpy(),
                        np.asarray(jax_dequant(jnode)))
                    assert torch.equal(back[layer][mod][leaf]["codes"],
                                       node["codes"])
                else:
                    np.testing.assert_array_equal(np.asarray(jnode),
                                                  node.numpy())
                seen.add((f"{mod}.{leaf}", tpl.is_qtensor(node)))
    assert {n for n, q in seen if q} == {
        "tm.w_r", "tm.w_k", "tm.w_v", "tm.w_g", "tm.w_o", "cm.w_k",
        "cm.w_v", "cm.w_r"}
    assert len(seen) == 19
    sp = serving_params(tq, get_smoke_config(ARCH))
    assert {f"{m}.{k}" for m in ("tm", "cm")
            for k, v in sp["layers"][1][m].items() if is_qt(v)} == \
        {n for n, q in seen if q}


def test_fake_quantize_params_wraps_the_rwkv_leaves_as_jax(jparams):
    from repro.core.apply import fake_quantize_params as jax_fake
    from repro_torch.core.apply import fake_quantize_params, is_qt
    cfg = get_smoke_config(ARCH)
    jf = jax_fake(jparams, jax_cfg(ARCH), JPlan(remat=False), bits=4)
    tf = fake_quantize_params(params_from_numpy(jparams, "cpu"), cfg,
                              BuildPlan(), bits=4)
    for mod, leaf in tpl.RWKV_TAPS:
        got = tf["layers"][1][mod][leaf]
        assert is_qt(got), (mod, leaf)
        want = jf["layers"][mod][leaf].dequant(jnp.float32)[1]
        np.testing.assert_allclose(got.dequant(torch.float32).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{mod}.{leaf}")
    for leaf in ("w1_ts", "w2_ts", "w1_decay", "w2_decay", "mu_rkvwg"):
        assert not is_qt(tf["layers"][0]["tm"][leaf]), leaf


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_equal_jax(jax_qparams):
    """The static Engine from packed codes at f32: the same greedy tokens
    as the JAX Engine, 8 steps past a 16-token prompt."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.serve import Engine
    jc, tc = _cfgs()
    prompts = _tokens(6, (3, 16))
    want = JEngine(jax_serving(jax_qparams, jc), jc, JPlan(remat=False),
                   max_len=24).generate_batch(prompts, max_new_tokens=8)
    with torch.no_grad():
        got = Engine(serving_params(qparams_from_numpy(jax_qparams, "cpu"),
                                    tc), tc, BuildPlan(), max_len=24,
                     device="cpu").generate_batch(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_runtime_and_decode_refuse_rwkv_as_jax():
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


def test_serve_launcher_switches_rwkv_to_the_static_engine(capsys):
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--quantize",
                             "--engine", "paged", "--num-requests", "2",
                             "--prompt-len", "16", "--max-new", "6",
                             "--device", "cpu"])
    text = capsys.readouterr().out
    assert "note: ssm/attention-free archs use the dense-cache static " \
        "engine" in text
    assert out["engine"] == "static" and out["new_tokens"] == 12
    assert json.loads(text.strip().splitlines()[-1])["engine"] == "static"


@pytest.mark.parametrize("flags", [
    [], ["--policy", "*.w_o=8,kv=8"], ["--bits-budget", "3.5"],
    ["--propagation", "legacy", "--no-guards"]])
def test_quantize_launcher_runs_rwkv(flags, capsys):
    from repro_torch.launch import quantize as launch_quantize
    s = _warnless(launch_quantize.main,
                  ["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                   "--calib-batch", "2", "--calib-seq", "48", "--device",
                   "cpu"] + flags)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
    assert s["arch"] == "rwkv6-7b-smoke" and s["layers_quantized"] == 16
    assert s["comq_vs_rtn_error_improvement"] > 0
    assert abs(s["quant_loss"] - s["fp_loss"]) <= 0.15
    assert s["mixed_policy"] == bool(flags and flags[0] in ("--policy",
                                                             "--bits-budget"))
