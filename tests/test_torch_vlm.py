"""The port's VLM (llama-3.2-vision-90b smoke: 10 layers in 2 groups of 4
self layers + 1 gated cross layer, d 64, 4/2 heads of 16, 17 image tokens
of width 32) against the JAX package, both on the JAX init converted
through numpy, with image features from a numpy seed: logits and the
cross layer's taps, the staged and legacy walks, prefill + decode, the
stripped checkpoint round trip, the static Engine, and the refusals the
JAX package makes.

The cross layers' gates are zero at init (tanh(0) = 0), so with JAX's
weights a cross layer adds nothing to the residual stream and the logits
cannot see the cross-attention. Every comparison meant to see it sets both
gates to 0.5 in the JAX params before converting (`_gated`).

Depth: the smoke's 10 random-init layers grow the residual stream to
|x| ~ 80, where one bf16 ulp is 0.5, and each layer carries the other
package's rounding on (at f32 ~1.4e-6 of |x| a layer, 3.1e-4 at the
logits after 10 layers). So the full smoke depth is held layer by layer
in lockstep (each layer from JAX's input), the walks at f32 compute, and
the end-to-end runs (logits, decode, Engine) on ONE_GROUP, the smoke cut
to the full config's group: 4 self layers and 1 cross layer. There f32
holds end to end within 1e-4; bf16 holds every layer in lockstep, in
prefill and in decode."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_cfg
from repro.configs.base import CrossAttnConfig as JCross
from repro.core import QuantSpec as JSpec
from repro.core import materialize as jax_materialize
from repro.core import quantize_model as jax_quantize
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import CrossAttnConfig
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core import QuantSpec, materialize, quantize_model
from repro_torch.core import pipeline as tpl
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-90b"
VOCAB = 256
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
ERR_RTOL = 0.05      # per-leaf errors downstream of layer 0's first group
GATE = 0.5
ONE_GROUP = dict(n_layers=5)    # the full config's group: 4 self + 1 cross


def _warnless(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # calibration tokens < d_ff
        return fn(*a, **k)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _features(seed, batch):
    ca = jax_cfg(ARCH).cross_attn
    return np.random.default_rng(seed).standard_normal(
        (batch, ca.n_vision_tokens, ca.vision_dim)).astype(np.float32)


def _gated(tree):
    """The JAX params with both gates of every cross layer at GATE."""
    cross = dict(tree["groups"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = np.full_like(np.asarray(cross[name]), GATE)
    return {**tree, "groups": {**tree["groups"], "cross": cross}}


def _cfgs(cd, one_group=False):
    jc = jax_cfg(ARCH).replace(compute_dtype=cd)
    tc = get_smoke_config(ARCH).replace(compute_dtype=cd)
    if one_group:
        jc = jc.replace(**ONE_GROUP)
        tc = tc.replace(**ONE_GROUP)
    return jc, tc


def _jax_init(one_group=False):
    return _gated(jax.device_get(jax_init(
        jax.random.PRNGKey(0), _cfgs("float32", one_group)[0],
        JPlan(remat=False))))


@pytest.fixture(scope="module")
def jparams():
    return _jax_init()


@pytest.fixture(scope="module")
def one_group():
    """ONE_GROUP's gated JAX params and its RTN codes, materialized."""
    jp = _jax_init(one_group=True)
    jc = _cfgs("float32", True)[0]
    jq, _ = _warnless(jax_quantize, jp, jc, JPlan(remat=False),
                      jnp.asarray(_tokens(0, (2, 48))), JSpec(**SPEC),
                      method="rtn", guards=False,
                      vision_embeds=jnp.asarray(_features(0, 2)))
    return jp, jax.device_get(jax_materialize(_jax_arrays(jq), jc))


def test_config_family_and_param_count():
    cfg = get_config(ARCH)
    ca = cfg.cross_attn
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.rope_theta, ca.every, ca.n_vision_tokens, ca.vision_dim) == (
        "vlm", 100, 8192, 64, 8, 128, 28672, 128256, 5e5, 5, 1601, 1280)
    tt.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="paged decode"):
        tt.check_paged(cfg)
    with pytest.raises(NotImplementedError, match="not a configuration"):
        tt.check_ported(cfg.replace(cross_attn=None))
    from repro.models.model import count_params
    assert tm.param_count(cfg) == count_params(jax_full(ARCH))
    small = get_smoke_config(ARCH)
    p = tm.init_params(small, seed=0, device="cpu")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert tm.param_count(small) == n == count_params(jax_cfg(ARCH))
    assert len(p["groups"]["self"]) == 2 and len(p["groups"]["self"][0]) == 4
    assert float(p["groups"]["cross"][0]["gate_attn"]) == 0.0   # as JAX


def test_convert_nests_the_group_stacks(jparams):
    tp = params_from_numpy(jparams, "cpu")
    w = np.asarray(jparams["groups"]["self"]["attn"]["wq"])     # (G, spg,..)
    np.testing.assert_array_equal(
        tp["groups"]["self"][1][2]["attn"]["wq"].numpy(), w[1, 2])
    assert tp["groups"]["cross"][1]["gate_mlp"].shape == ()
    assert float(tp["groups"]["cross"][1]["gate_mlp"]) == GATE
    assert "layers" not in tp and tp["vision_proj"].shape == (32, 64)


def _ulp(x) -> float:
    """One bf16 ulp at the magnitude of max|x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _check_layer(got, want, cd, what):
    """f32 within 1e-4; bf16 a layer's output within 2 ulps of its
    magnitude (one flipped rounding of a residual value), mean under 1/20
    ulp."""
    want, got = np.asarray(want, np.float32), got.float().numpy()
    if cd == "float32":
        assert_close(got, want, cd, what)
        return
    err = np.abs(got - want)
    assert err.max() <= 2 * _ulp(want), (what, float(err.max()))
    assert err.mean() <= _ulp(want) / 20, (what, float(err.mean()))


def _to_port(a, cd):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, cd))


def _check_head(jp, tp, jc, tc, jx, cd, what):
    """The head (final norm, unembed) from JAX's hidden state, under the
    dense test's bound. Returns JAX's logits."""
    from repro.models.common import apply_norm as jax_norm
    from repro_torch.models.common import apply_norm
    jl = jm.unembed(jp, jc, JPlan(), jax_norm(jp["final_norm"], jx, jc))
    with torch.no_grad():
        tl = tm.unembed(tp, tc, BuildPlan(),
                        apply_norm(tp["final_norm"], _to_port(jx, cd), tc))
    assert_close(tl.float().numpy(), jl, cd, what)
    return jl


def _prefill_in_lockstep(jp, tp, jc, tc, cd, tok, ve, jplan=None,
                         tplan=None):
    """Every layer of both packages, self and cross, from JAX's input
    (`_check_layer`), after the projected image. With plans, each layer
    also builds its cache (from JAX's input). Returns (JAX's last hidden
    state, [(JAX cache, port cache) per self layer, by group], [(JAX image
    K/V, port image K/V) per group])."""
    make_cache = jplan is not None
    jplan, tplan = jplan or JPlan(remat=False), tplan or BuildPlan()
    jx = jm.embed_tokens(jp, jc, jplan, jnp.asarray(tok))
    jve = jnp.einsum("bnv,vd->bnd", jnp.asarray(ve).astype(jx.dtype),
                     jnp.asarray(jp["vision_proj"]).astype(jx.dtype))
    tve = torch.einsum("bnv,vd->bnd", _to_port(ve, cd),
                       tp["vision_proj"].to(getattr(torch, cd)))
    _check_layer(tve, jve, cd, "projected image")
    caches, xkv = [], []
    for g, (tself, tcp) in enumerate(zip(tp["groups"]["self"],
                                         tp["groups"]["cross"])):
        group = []
        for s, tlp in enumerate(tself):
            lp = jax.tree_util.tree_map(lambda a: a[g, s],
                                        jp["groups"]["self"])
            tin = _to_port(jx, cd)
            jx, jc_l = jt.layer_full(lp, jx, jc, jplan, make_cache)[:2]
            with torch.no_grad():
                tx, tc_l = tt.layer_full(tlp, tin, tc, tplan, make_cache)[:2]
            _check_layer(tx, jx, cd, f"group {g} self layer {s}")
            group.append((jc_l, tc_l))
        caches.append(group)
        cp = jax.tree_util.tree_map(lambda a: a[g], jp["groups"]["cross"])
        jkv = jt.vision_kv_for_layer(cp, jve)
        tin = _to_port(jx, cd)
        jx = jt.cross_layer_full(cp, jx, jc, jplan, jkv)
        with torch.no_grad():
            tkv = tt.vision_kv_for_layer(tcp, _to_port(jve, cd))
            tx = tt.cross_layer_full(tcp, tin, tc, tplan, tkv)
        _check_layer(tx, jx, cd, f"group {g} cross layer")
        xkv.append((jkv, tkv))
    return jx, caches, xkv


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_match_jax(one_group, cd):
    """ONE_GROUP (4 self layers + 1 cross layer, the full config's group)
    with the gates at 0.5, which make the cross-attention reach the logits
    (checked: zero gates move them). f32 end to end within 1e-4. bf16
    with every layer from JAX's input (`_prefill_in_lockstep`) and the
    logits from JAX's last state under the dense test's bound: end to end,
    the two frameworks' bf16 rounding sites put the logits 0.37 apart,
    less than JAX's own bf16 logits are from its f32 ones (1.07), so there
    the comparison would measure the random-init model."""
    jc, tc = _cfgs(cd, True)
    tok, ve = _tokens(1, (2, 24)), _features(2, 2)
    tp = params_from_numpy(one_group[0], "cpu")
    if cd == "bfloat16":
        jx, _, _ = _prefill_in_lockstep(one_group[0], tp, jc, tc, cd, tok, ve)
        _check_head(one_group[0], tp, jc, tc, jx, cd, "logits")
        return
    jl = np.asarray(jm.forward(one_group[0], jc, JPlan(remat=False),
                               jnp.asarray(tok),
                               vision_embeds=jnp.asarray(ve))[0], np.float32)
    with torch.no_grad():
        tl = tm.forward(tp, tc, BuildPlan(), torch.from_numpy(tok).long(),
                        vision_embeds=torch.from_numpy(ve))[0]
    assert_close(tl.float().numpy(), jl, cd, "logits")
    for g in tp["groups"]["cross"]:
        g["gate_attn"] = torch.zeros(())
    with torch.no_grad():
        t0 = tm.forward(tp, tc, BuildPlan(), torch.from_numpy(tok).long(),
                        vision_embeds=torch.from_numpy(ve))[0]
    assert float((t0 - tl).abs().max()) > 1e-2


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_every_layer_matches_jax_in_lockstep(jparams, cd):
    """The full smoke depth, each of the 10 layers (self and cross) run
    from JAX's input, then the head (final norm, unembed) from JAX's last
    hidden state: `_check_layer`, then the dense test's bound."""
    jc, tc = _cfgs(cd)
    tp = params_from_numpy(jparams, "cpu")
    tok, ve = _tokens(1, (2, 24)), _features(2, 2)
    jx, _, _ = _prefill_in_lockstep(jparams, tp, jc, tc, cd, tok, ve)
    _check_head(jparams, tp, jc, tc, jx, cd, "logits from JAX's last state")


def test_cross_layer_taps_match_jax(jparams):
    """The cross layer's four taps (f32 within 1e-4), on group 0's cross
    layer over the projected image."""
    jc, tc = _cfgs("float32")
    tp = params_from_numpy(jparams, "cpu")
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    ve = _features(5, 2)
    jcp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"]["cross"])
    jve = jnp.einsum("bnv,vd->bnd", jnp.asarray(ve),
                     jnp.asarray(jparams["vision_proj"]))
    jtaps, ttaps = {}, {}
    jy = jt.cross_layer_full(jcp, jnp.asarray(x), jc, JPlan(remat=False),
                             jt.vision_kv_for_layer(jcp, jve), taps=jtaps)
    with torch.no_grad():
        tve = torch.einsum("bnv,vd->bnd", torch.from_numpy(ve),
                           tp["vision_proj"])
        tcp = tp["groups"]["cross"][0]
        ty = tt.cross_layer_full(tcp, torch.from_numpy(x), tc, BuildPlan(),
                                 tt.vision_kv_for_layer(tcp, tve),
                                 taps=ttaps)
    assert list(ttaps) == list(jtaps) == ["xattn_q_in", "xattn_wo_in",
                                          "mlp_in", "down_in"]
    for name in jtaps:
        assert_close(ttaps[name].numpy(), jtaps[name], "float32", name)
    assert_close(ty.numpy(), jy, "float32", "cross layer output")


def _leaves(table):
    return {f"{key}.{mod}.{leaf}": v for key, lp in table.items()
            for mod, leaves in lp.items() if isinstance(leaves, dict)
            for leaf, v in leaves.items() if tpl.is_qtensor(v)}


def _quantize_both(jparams, propagation):
    """Both walks at f32 compute (see the module docstring on depth)."""
    tok, ve = _tokens(0, (2, 48)), _features(0, 2)
    jc, tc = _cfgs("float32")
    jq, jrep = _warnless(jax_quantize, jparams, jc,
                         JPlan(remat=False), jnp.asarray(tok), JSpec(**SPEC),
                         method="comq_blocked", guards=False,
                         propagation=propagation,
                         vision_embeds=jnp.asarray(ve))
    tq, trep = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                         tc, BuildPlan(),
                         torch.from_numpy(tok).long(), QuantSpec(**SPEC),
                         method="comq_blocked", propagation=propagation,
                         vision_embeds=torch.from_numpy(ve))
    return jax.device_get(jq), jrep, tq, trep


@pytest.fixture(scope="module")
def staged(jparams):
    return _quantize_both(jparams, "staged")


@pytest.mark.parametrize("propagation", ["staged", "legacy"])
def test_quantize_matches_jax(jparams, staged, propagation):
    """The leaf inventory (table keys, "cross." names, layer indices
    g·5 + s and g·5 + 4) equals JAX's; layer 0's attn_in group has JAX's
    codes bit for bit; every leaf's errors within ERR_RTOL; the cross
    layers' wk / wv stay float."""
    jq, jrep, tq, trep = (staged if propagation == "staged"
                          else _quantize_both(jparams, "legacy"))
    jl, tl = _leaves(jq["__qlayers__"]), _leaves(tq["__qlayers__"])
    assert sorted(tq["__qlayers__"]) == sorted(jq["__qlayers__"])
    assert jl.keys() == tl.keys() and len(tl) == 2 * (4 * 7 + 5)
    for leaf in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(
            tl[f"self_0_0.attn.{leaf}"]["codes"].numpy(),
            np.asarray(jl[f"self_0_0.attn.{leaf}"]["codes"]), err_msg=leaf)
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    cross = [(r.layer, r.name) for r in trep.layers
             if r.name.startswith("cross.")]
    assert cross[0] == (4, "cross.xattn.wq") and cross[-1][0] == 9
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    assert trep.total_improvement() > 0 and not trep.guard_events
    wk = tq["__qlayers__"]["cross_1"]["xattn"]["wk"]
    assert isinstance(wk, torch.Tensor) and wk.dtype == torch.float32


def test_policy_rules_resolve_cross_names(jparams):
    """A rule on "cross.*" leaves reaches only the cross layers' solves."""
    from repro_torch.core import QuantPolicy
    pol = QuantPolicy(base=QuantSpec(**SPEC), rules=(("cross.mlp.*", 8),))
    tq, _ = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                      get_smoke_config(ARCH), BuildPlan(),
                      torch.from_numpy(_tokens(0, (2, 48))).long(), pol,
                      method="comq_blocked",
                      vision_embeds=torch.from_numpy(_features(0, 2)))
    bits = {k: v["bits"] for k, v in _leaves(tq["__qlayers__"]).items()}
    assert bits["cross_0.mlp.w_down"] == bits["cross_1.mlp.w_up"] == 8
    assert bits["cross_0.xattn.wq"] == bits["self_0_0.mlp.w_down"] == 4


def test_vision_features_are_validated_as_jax():
    from repro.data import validate_calib_features as jax_validate
    from repro_torch.data import CalibrationDataError
    from repro_torch.data import validate_calib_features
    ve = _features(0, 2)
    assert validate_calib_features(torch.from_numpy(ve)) is not None
    jax_validate(ve)
    bad = ve.copy()
    bad[0, 1, 2] = np.nan
    for arg, what in ((bad, "non-finite"), (ve[:0], "empty"),
                      (ve.astype(np.int32), "floating"), (None, "None")):
        with pytest.raises(CalibrationDataError, match=what):
            validate_calib_features(arg)
        with pytest.raises(Exception, match=what):
            jax_validate(arg)
    tok = torch.from_numpy(_tokens(0, (2, 48))).long()
    with pytest.raises(CalibrationDataError, match="None"):
        quantize_model(tm.init_params(get_smoke_config(ARCH), device="cpu"),
                       get_smoke_config(ARCH), BuildPlan(), tok,
                       QuantSpec(**SPEC))


def _jax_arrays(jq):
    """JAX's materialize updates the dense stacks in place (`.at`): hand
    it device arrays."""
    return {**jq, "groups": jax.tree_util.tree_map(jnp.asarray,
                                                   jq["groups"])}


def test_stripped_checkpoint_materializes(staged):
    """strip_for_serving drops the "groups" stacks; materialize rebuilds
    them from the table bit for bit (JAX's round trip), and the port's
    materialized model equals JAX's on JAX's codes."""
    from repro_torch.ckpt import (pack_tree, strip_for_serving, tree_bytes,
                                  unpack_tree)
    jq, _, tq, _ = staged
    cfg = get_smoke_config(ARCH)
    stripped = pack_tree(strip_for_serving(tq))
    assert "groups" not in stripped
    assert tree_bytes(stripped) < tree_bytes(pack_tree(tq))
    mat_a = materialize(tq, cfg)
    mat_b = materialize(unpack_tree(stripped), cfg)
    want = params_from_numpy(jax.device_get(jax_materialize(
        _jax_arrays(jq), jax_cfg(ARCH))), "cpu")
    la, lb, lw = (jax.tree_util.tree_leaves(m) for m in (mat_a, mat_b, want))
    assert len(la) == len(lb) == len(lw)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    got = materialize(qparams_from_numpy(jq, "cpu"), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got), lw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def _decode_in_lockstep(jmat, tmat, jc, tc, cd, prompt, ve, steps, jplan,
                        tplan):
    """Prefill, then `steps` teacher-forced decode steps on JAX's greedy
    tokens, each layer of both packages from JAX's input: the self layers
    over each package's own cache (built from JAX's inputs), the cross
    layers over each one's image K/V. Every layer is held by
    `_check_layer` and each step's logits by `_check_head`."""
    jx, caches, xkv = _prefill_in_lockstep(jmat, tmat, jc, tc, cd, prompt, ve,
                                           jplan, tplan)
    T = prompt.shape[1]
    jl = _check_head(jmat, tmat, jc, tc, jx[:, -1:], cd, "prefill")
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
        jx = jm.embed_tokens(jmat, jc, jplan, jnp.asarray(tok[:, None]))
        for g, group in enumerate(caches):
            for s, (jkv, tkv) in enumerate(group):
                lp = jax.tree_util.tree_map(lambda a: a[g, s],
                                            jmat["groups"]["self"])
                tin = _to_port(jx, cd)
                jx, jkv = jt.layer_decode(lp, jx, jc, jplan, jkv,
                                          jnp.int32(T + i))[:2]
                with torch.no_grad():
                    tx, tkv = tt.layer_decode(tmat["groups"]["self"][g][s],
                                              tin, tc, tplan, tkv, T + i)[:2]
                _check_layer(tx, jx, cd, f"step {i} group {g} self {s}")
                group[s] = (jkv, tkv)
            cp = jax.tree_util.tree_map(lambda a: a[g],
                                        jmat["groups"]["cross"])
            tin = _to_port(jx, cd)
            jx = jt.layer_decode(cp, jx, jc, jplan, None, jnp.int32(T + i),
                                 vision_kv=xkv[g][0], is_cross=True)[0]
            with torch.no_grad():
                tx = tt.cross_layer_full(tmat["groups"]["cross"][g], tin, tc,
                                         tplan, xkv[g][1])
            _check_layer(tx, jx, cd, f"step {i} group {g} cross")
        jl = _check_head(jmat, tmat, jc, tc, jx, cd, f"step {i}")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(one_group, cd):
    """ONE_GROUP from its materialized codes (gates 0.5): prefill of 16
    tokens with the image, then 4 teacher-forced steps over the four self
    layers' cached K/V and the image's K/V. f32: `prefill` and
    `decode_step` end to end within 1e-4 of JAX's. bf16: every layer of
    every step from JAX's input (`_decode_in_lockstep`; end to end the
    rounding sites carry the prefill logits 0.24 apart, as in
    `test_forward_logits_match_jax`)."""
    jc, tc = _cfgs(cd, True)
    jmat = one_group[1]
    tmat = params_from_numpy(jmat, "cpu")
    jmat = _jax_arrays(jmat)
    prompt, ve, steps = _tokens(3, (2, 16)), _features(6, 2), 4
    jplan = JPlan(remat=False, prefill_cache_len=20,
                  cache_dtype=jnp.dtype(cd))
    tplan = BuildPlan(prefill_cache_len=20, cache_dtype=getattr(torch, cd))
    if cd == "bfloat16":
        _decode_in_lockstep(jmat, tmat, jc, tc, cd, prompt, ve, steps, jplan,
                            tplan)
        return
    jl, jcache = jm.prefill(jmat, jc, jplan, jnp.asarray(prompt),
                            vision_embeds=jnp.asarray(ve))
    with torch.no_grad():
        tl, tcache = tm.prefill(tmat, tc, tplan,
                                torch.from_numpy(prompt).long(),
                                vision_embeds=torch.from_numpy(ve))
        assert tcache["xkv"][0].shape == (1, 2, 17, 2, 16)
        assert len(tcache["kv"]) == 1 and len(tcache["kv"][0]) == 4
        for i in range(steps + 1):
            assert_close(tl.float().numpy(), jl, cd, f"step {i}")
            if i == steps:
                break
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jcache = jm.decode_step(jmat, jc, jplan, jcache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.int32(16 + i))
            tl, tcache = tm.decode_step(tmat, tc, tplan, tcache,
                                        torch.from_numpy(tok[:, None]).long(),
                                        16 + i)


def test_init_cache_shapes_match_jax():
    jc, tc = _cfgs("bfloat16")
    jcache = jm.init_cache(jc, JPlan(remat=False), 3, 40)
    tcache = tm.init_cache(tc, BuildPlan(), 3, 40, device="cpu")
    assert tuple(tcache["xkv"][1].shape) == jcache["xkv"][1].shape
    assert tcache["xkv"][0].dtype == torch.bfloat16
    assert tuple(tcache["kv"][1][3].k.shape) == jcache["kv"].k.shape[2:]


def test_engine_greedy_tokens_equal_jax(one_group):
    """The static Engine over ONE_GROUP's materialized codes with the image,
    f32: JAX's Engine's greedy tokens."""
    from repro.serve import Engine as JEngine
    from repro_torch.serve import Engine
    jc, tc = _cfgs("float32", True)
    prompts, ve = _tokens(9, (3, 12)), _features(10, 3)
    want = JEngine(_jax_arrays(one_group[1]), jc,
                   JPlan(remat=False, cache_dtype=jnp.float32),
                   max_len=20).generate_batch(prompts, max_new_tokens=6,
                                              vision_embeds=jnp.asarray(ve))
    with torch.no_grad():
        got = Engine(params_from_numpy(one_group[1], "cpu"), tc,
                     BuildPlan(cache_dtype=torch.float32), max_len=20,
                     device="cpu").generate_batch(prompts, max_new_tokens=6,
                                                  vision_embeds=ve)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serving_params_and_curves_refuse_as_jax(jparams, staged):
    from repro.core.apply import serving_params as jax_serving
    from repro.core.policy import measure_bit_curves as jax_curves
    from repro_torch.core.apply import serving_params
    from repro_torch.core.policy import measure_bit_curves
    from repro_torch.models import decode_step_paged
    jq, _, tq, _ = staged
    msg = "materialize\\(\\) the VLM group table"
    with pytest.raises(NotImplementedError, match=msg):
        jax_serving(jq, jax_cfg(ARCH))
    with pytest.raises(NotImplementedError, match=msg):
        serving_params(tq, get_smoke_config(ARCH))
    tok = _tokens(0, (2, 48))
    msg = "homogeneous stacks; resolve VLM"
    with pytest.raises(NotImplementedError, match=msg):
        jax_curves(jparams, jax_cfg(ARCH), JPlan(remat=False),
                   jnp.asarray(tok), JSpec(**SPEC))
    with pytest.raises(NotImplementedError, match=msg):
        measure_bit_curves(params_from_numpy(jparams, "cpu"),
                           get_smoke_config(ARCH), BuildPlan(),
                           torch.from_numpy(tok).long(), QuantSpec(**SPEC))
    with pytest.raises(NotImplementedError, match="paged decode"):
        decode_step_paged(params_from_numpy(jparams, "cpu"),
                          get_smoke_config(ARCH), BuildPlan(), None, None,
                          None, None)


def test_quantize_launcher_runs_the_vlm(capsys):
    from repro_torch.launch import quantize as launch_quantize
    s = _warnless(launch_quantize.main,
                  ["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                   "--calib-batch", "2", "--calib-seq", "48", "--device",
                   "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
    assert s["arch"] == "llama-3.2-vision-90b-smoke"
    assert s["layers_quantized"] == 2 * (4 * 7 + 5)
    assert s["comq_vs_rtn_error_improvement"] > 0.3
    assert abs(s["quant_loss"] - s["fp_loss"]) <= 0.15


def test_serve_launcher_says_why_it_stops(capsys):
    """JAX's launcher switches a VLM to the static engine and then fails
    for want of image features; the port's says so and exits."""
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(SystemExit, match="vision_embeds"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--num-requests", "2",
                           "--device", "cpu"])
    assert "static engine" in capsys.readouterr().out
