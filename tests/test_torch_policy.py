"""The port's mixed-precision policy engine against the JAX package
(repro_torch.core.policy vs repro.core.policy): resolution and parsing,
the budgeted allocator on the same curves, measured curves and the budget
allocation on qwen2-7b smoke, a mixed-policy quantize_model, serving its
packed mixed-width codes, the policy metadata of a .qpk, the legacy
schedule, the X-space solver, GramAccumulator, fake_quantize_params, the
int8 static KV cache, and the launcher's policy flags."""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.quantized import load_packed_ckpt as jax_load
from repro.ckpt.quantized import restore_policy as jax_restore_policy
from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantPolicy as JPolicy
from repro.core import QuantSpec as JSpec
from repro.core import allocate_bits as jax_allocate
from repro.core import measure_bit_curves as jax_curves
from repro.core import parse_policy as jax_parse
from repro.core import policy_from_budget as jax_budget
from repro.core import quantize_model as jax_quantize
from repro.core import policy as jpol
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import attention as jattn
from repro_torch.ckpt import (load_packed_ckpt, pack_tree, policy_extra,
                              restore_policy, save_packed_ckpt)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import (QuantPolicy, QuantSpec, allocate_bits,
                              as_policy, materialize, measure_bit_curves,
                              parse_policy, policy_from_budget,
                              quantize_model)
from repro_torch.core import policy as tpol
from repro_torch.core.apply import serving_params
from repro_torch.core.pipeline import is_qtensor
from repro_torch.launch import quantize as launcher
from repro_torch.models import BuildPlan
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
# all four widths, and a mixed-width group (4/4/3 bits) on layer 0's
# attn_in tap, the one tap both packages compute from the same embedding
RULES = (("0.mlp.w_down", 8), ("0.attn.wv", 3), ("1.attn.wk", 2),
         ("1.mlp.w_gate", 3))
# same weights and tokens; the bf16 taps differ by rounding between the
# frameworks (tests/test_torch_model.py), which moves per-leaf errors and
# curve points by a few percent (tests/test_torch_pipeline.py)
ERR_RTOL = 0.05


def _warnless(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 96 calibration tokens < d_ff
        return fn(*a, **k)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (2, 48)).astype(
        np.int32)


def _leaves(table):
    out = {}
    for l, lp in table.items():
        for mod, leaves in lp.items():
            if isinstance(leaves, dict):
                for leaf, v in leaves.items():
                    if is_qtensor(v):
                        out[f"{l}.{mod}.{leaf}"] = v
    return out


@pytest.fixture(scope="module")
def mixed(jparams, tokens):
    """One JAX and one port quantize_model under the same mixed policy."""
    jrun = _warnless(jax_quantize, jparams, jax_cfg(ARCH), JPlan(remat=False),
                     jnp.asarray(tokens),
                     JPolicy(base=JSpec(**SPEC), rules=RULES),
                     method="comq_blocked")
    trun = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                     get_smoke_config(ARCH), BuildPlan(),
                     torch.from_numpy(tokens).long(),
                     QuantPolicy(base=QuantSpec(**SPEC), rules=RULES),
                     method="comq_blocked")
    return jrun, trun


# ---------------------------------------------------------------------------
# resolution, parsing, metadata
# ---------------------------------------------------------------------------

POLICIES = [
    dict(rules=(("*.w_down", 8), ("2.attn.wq", 3)), first_layer_bits=8,
         last_layer_bits=8),
    dict(rules=(("mlp.*", 2), ("mlp.w_down", 8))),
    dict(rules=(("1.attn.w?", 3),), last_layer_bits=2),
    dict(),
]
LEAF_NAMES = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate",
              "mlp.w_up", "mlp.w_down", "unembed"]


@pytest.mark.parametrize("kw", POLICIES)
def test_resolve_matches_jax(kw):
    """Every (layer, leaf) of a 6-layer model, and the unembed at layer
    -1, resolves to the JAX package's spec; only the bits vary."""
    tp = QuantPolicy(base=QuantSpec(**SPEC), **kw)
    jp = JPolicy(base=JSpec(**SPEC), **kw)
    n = 6
    for layer in range(-1, n):
        for name in LEAF_NAMES:
            got, want = tp.resolve(name, layer, n), jp.resolve(name, layer, n)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (layer, name)
    assert tp.is_uniform() == jp.is_uniform() == (not kw)
    r = tp.resolve("mlp.w_down", 3, n)
    assert (r.granularity, r.lam, r.sweeps, r.order) == \
        (SPEC["granularity"], SPEC["lam"], SPEC["sweeps"], SPEC["order"])


def test_resolution_order_and_as_policy():
    """The JAX test's cases (tests/test_policy.py): rules first (first
    match wins), then first/last, then the base."""
    base = QuantSpec(**SPEC)
    pol = QuantPolicy(base=base, rules=(("*.w_down", 8), ("2.attn.wq", 3)),
                      first_layer_bits=8, last_layer_bits=8)
    assert pol.resolve("mlp.w_down", 0, 6).bits == 8
    assert pol.resolve("attn.wq", 2, 6).bits == 3
    assert pol.resolve("attn.wq", 3, 6).bits == 4
    assert pol.resolve("attn.wq", 0, 6).bits == 8
    assert pol.resolve("attn.wq", 5, 6).bits == 8
    first = QuantPolicy(base=base, rules=(("mlp.*", 2), ("mlp.w_down", 8)))
    assert first.resolve("mlp.w_down", 1, 4).bits == 2
    assert as_policy(base).resolve("attn.wq", 0, 4) == base
    assert as_policy(pol) is pol
    with pytest.raises(TypeError):
        as_policy({"bits": 4})


@pytest.mark.parametrize("text", [
    "*.w_down=8,first=8,last=8,kv=8,3.attn.wq=2",
    "kv=4", " 0.mlp.w_down=8 , 1.attn.wk=2,,1.mlp.w_gate=3,kv=8", ""])
def test_parse_policy_matches_jax(text):
    got = tpol.policy_to_dict(parse_policy(text, QuantSpec(**SPEC)))
    want = jpol.policy_to_dict(jax_parse(text, JSpec(**SPEC)))
    assert got == want


def test_parse_policy_rejects_a_rule_without_bits():
    with pytest.raises(ValueError):
        parse_policy("w_down", QuantSpec(**SPEC))
    with pytest.raises(ValueError):
        parse_policy("kv=", QuantSpec(**SPEC))


def test_policy_dict_roundtrip_across_packages():
    pol = QuantPolicy(base=QuantSpec(**SPEC), rules=(("*.w_down", 8),),
                      first_layer_bits=8, kv_bits=8)
    d = tpol.policy_to_dict(pol)
    assert tpol.policy_from_dict(d) == pol
    assert json.loads(json.dumps(d)) == d
    jp = jpol.policy_from_dict(d)
    assert jpol.policy_to_dict(jp) == d


# ---------------------------------------------------------------------------
# the allocator: exactly JAX's result on the same curves
# ---------------------------------------------------------------------------

def _toy_curves():
    curves = {"a": {2: 8.0, 3: 4.0, 4: 2.0, 8: 0.5},
              "b": {2: 4.0, 3: 2.0, 4: 1.0, 8: 0.25},
              "c": {2: 100.0, 3: 10.0, 4: 1.0, 8: 0.0},
              # non-convex: 3 -> 4 gains more a bit than 2 -> 3, and a
              # non-monotone point the envelope clips
              "x": {2: 10.0, 3: 9.9, 4: 1.0, 8: 1.5}}
    sizes = {"a": 1000, "b": 1000, "c": 10, "x": 100}
    return curves, sizes


def _random_curves(seed, n=40):
    rs = np.random.RandomState(seed)
    curves, sizes = {}, {}
    for i in range(n):
        e2 = rs.rand() * 10 + 1
        drops = rs.rand(3) * 0.9 + 0.05
        pts = [e2, e2 * drops[0], e2 * drops[0] * drops[1],
               e2 * drops[0] * drops[1] * drops[2]]
        if i % 5 == 0:      # a bump: non-monotone, non-convex
            pts[1] = pts[0] * 1.01
        curves[f"{i // 7}.leaf{i}"] = dict(zip((2, 3, 4, 8), map(float,
                                                                 pts)))
        sizes[f"{i // 7}.leaf{i}"] = int(rs.choice([512, 4096, 18944]))
    return curves, sizes


@pytest.mark.parametrize("budget", [2.0, 2.25, 2.5, 3.0, 3.5, 4.0, 5.5,
                                    7.99, 8.0, 16.0])
@pytest.mark.parametrize("curves", ["toy", 0, 1, 2])
def test_allocate_bits_equals_jax(curves, budget):
    c, s = _toy_curves() if curves == "toy" else _random_curves(curves)
    got = allocate_bits(c, s, budget)
    assert got == jax_allocate(c, s, budget)
    assert tpol.alloc_bits_per_param(got, s) == \
        jpol.alloc_bits_per_param(got, s)
    assert tpol.alloc_bits_per_param(got, s) <= budget + 1e-9
    assert tpol.alloc_bytes_per_param(got, s) == \
        jpol.alloc_bytes_per_param(got, s)


def test_allocator_nonconvex_and_endpoints():
    c, s = _toy_curves()
    assert allocate_bits({"x": c["x"]}, {"x": 100}, 4.0) == {"x": 4}
    assert set(allocate_bits(c, s, 2.0).values()) == {2}
    assert set(allocate_bits(c, s, 8.0).values()) == {8}
    assert allocate_bits(c, s, 3.0)["c"] == 8
    with pytest.raises(ValueError):
        allocate_bits(c, s, 1.0)
    with pytest.raises(ValueError):
        allocate_bits(c, {"a": 1}, 4.0)
    with pytest.raises(ValueError):
        allocate_bits({"a": {2: 1.0}}, {"a": 1}, 4.0)


def test_allocator_nests_and_error_falls_with_the_budget():
    c, s = _random_curves(3)
    prev = None
    for budget in np.linspace(2.0, 8.0, 25):
        alloc = allocate_bits(c, s, float(budget))
        if prev is not None:
            assert all(alloc[k] >= prev[k] for k in alloc)
        prev = alloc


# ---------------------------------------------------------------------------
# measured curves and the budget allocation on the smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def curves(jparams, tokens):
    base = JSpec(**SPEC)
    jc, js = jax_curves(jparams, jax_cfg(ARCH), JPlan(remat=False),
                        jnp.asarray(tokens), base)
    tc, ts = measure_bit_curves(params_from_numpy(jparams, "cpu"),
                                get_smoke_config(ARCH), BuildPlan(),
                                torch.from_numpy(tokens).long(),
                                QuantSpec(**SPEC))
    return jc, js, tc, ts


def test_measure_bit_curves_match_jax(curves):
    jc, js, tc, ts = curves
    assert ts == js and len(tc) == 14
    for name in jc:
        assert sorted(tc[name]) == [2, 3, 4, 8]
        for b in jc[name]:
            np.testing.assert_allclose(tc[name][b], jc[name][b],
                                       rtol=ERR_RTOL, err_msg=f"{name} {b}")
        c = tc[name]
        assert c[2] >= c[3] >= c[4] >= c[8] >= 0.0, (name, c)


def test_measure_bit_curves_comq_blocked_is_the_solve_error(jparams,
                                                             tokens):
    """curve_method="comq_blocked" prices a width with the blocked solve's
    final error: the port's pipeline solve on the same Gram."""
    from repro_torch.core import calibrate, pipeline
    from repro_torch.models import transformer as tt
    cfg, p = get_smoke_config(ARCH), params_from_numpy(jparams, "cpu")
    tok = torch.from_numpy(tokens).long()
    c, _ = measure_bit_curves(p, cfg, BuildPlan(), tok, QuantSpec(**SPEC),
                              choices=(2, 8), curve_method="comq_blocked")
    taps = {}
    with torch.no_grad():
        x = tm.embed_tokens(p, cfg, BuildPlan(), tok)
        tt.layer_full(p["layers"][0], x, cfg, BuildPlan(), False, taps=taps)
    h = calibrate.gram_from_tap(taps["attn_in"])
    w = pipeline._w2d(p["layers"][0]["attn"]["wk"], h.shape[0])
    for b in (2, 8):
        r = pipeline.solve(h, w, QuantSpec(**{**SPEC, "bits": b}),
                           "comq_blocked")
        assert c["0.attn.wk"][b] == float(r.errors[-1])
    assert c["0.attn.wk"][8] < c["0.attn.wk"][2]


def test_measure_bit_curves_unembed_and_other_families(jparams, tokens):
    """include_unembed prices the unembedding on the final-norm
    activations; a configuration the port does not run (here a VLM
    without cross-attention) raises."""
    cfg, p = get_smoke_config(ARCH), params_from_numpy(jparams, "cpu")
    tok = torch.from_numpy(tokens).long()
    c, s = measure_bit_curves(p, cfg, BuildPlan(), tok, QuantSpec(**SPEC),
                              include_unembed=True)
    assert s["unembed"] == cfg.d_model * cfg.vocab_size and len(c) == 15
    u = c["unembed"]
    assert u[2] >= u[3] >= u[4] >= u[8] >= 0.0
    with pytest.raises(NotImplementedError, match="not a configuration"):
        measure_bit_curves(p, cfg.replace(family="vlm"), BuildPlan(), tok,
                           QuantSpec(**SPEC))


def _steps(curves, sizes, choices=(2, 3, 4, 8)):
    """The allocator's sorted (ratio, leaf, bits) upgrade steps."""
    ups = []
    for leaf in sorted(curves):
        mono, best = {}, float("inf")
        for b in choices:
            best = min(best, curves[leaf][b])
            mono[b] = best
        steps = []
        for lo, hi in zip(choices, choices[1:]):
            steps.append([(hi - lo) * sizes[leaf], mono[lo] - mono[hi], hi])
            while (len(steps) >= 2 and steps[-1][1] * steps[-2][0]
                   > steps[-2][1] * steps[-1][0]):
                c2, g2, h2 = steps.pop()
                c1, g1, _ = steps.pop()
                steps.append([c1 + c2, g1 + g2, h2])
        ups += [(g / c, leaf, hi) for c, g, hi in steps]
    return sorted(ups, key=lambda t: (-t[0], t[1], t[2]))


@pytest.mark.parametrize("budget", [2.5, 3.0, 3.5, 4.0, 6.0])
def test_policy_from_budget_matches_jax(curves, jparams, tokens, budget):
    """The same per-leaf assignment as JAX. Where the two differ, the two
    upgrade steps whose order crosses must have gain/cost ratios within
    the curve tolerance of each other — a rounding-level swap, not a
    different allocator."""
    jc, js, tc, _ = curves
    jpolicy, jalloc, _ = jax_budget(jparams, jax_cfg(ARCH),
                                    JPlan(remat=False), jnp.asarray(tokens),
                                    JSpec(**SPEC), budget, kv_bits=4)
    tpolicy, talloc, tsizes = policy_from_budget(
        params_from_numpy(jparams, "cpu"), get_smoke_config(ARCH),
        BuildPlan(), torch.from_numpy(tokens).long(), QuantSpec(**SPEC),
        budget, kv_bits=4)
    assert tpol.alloc_bits_per_param(talloc, tsizes) <= budget + 1e-9
    assert tpolicy.kv_bits == 4
    for name, bits in talloc.items():
        layer, leaf = name.split(".", 1)
        assert tpolicy.resolve(leaf, int(layer), 2).bits == bits
    if talloc == jalloc:
        assert tpol.policy_to_dict(tpolicy) == jpol.policy_to_dict(jpolicy)
        return
    ts, jsteps = _steps(tc, js), _steps(jc, js)
    i = next(k for k, (a, b) in enumerate(zip(ts, jsteps))
             if a[1:] != b[1:])
    a, b = ts[i], next(s for s in ts if s[1:] == jsteps[i][1:])
    gap = abs(a[0] - b[0]) / max(a[0], b[0])
    assert gap <= 2 * ERR_RTOL, (a, b, gap)


# ---------------------------------------------------------------------------
# quantize_model under a policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["greedy", "cyclic"])
def test_uniform_policy_bit_identical_to_spec(jparams, tokens, order):
    """QuantPolicy(base=spec) gives the plain QuantSpec run's codes,
    zero-points and scales exactly — per-leaf solves (greedy) and the
    column-fused shared-tap solves (cyclic) alike."""
    spec = QuantSpec(**{**SPEC, "order": order})
    p = params_from_numpy(jparams, "cpu")
    tok = torch.from_numpy(tokens).long()
    cfg = get_smoke_config(ARCH)
    a, _ = _warnless(quantize_model, p, cfg, BuildPlan(), tok, spec,
                     method="comq_blocked")
    b, _ = _warnless(quantize_model, p, cfg, BuildPlan(), tok,
                     QuantPolicy(base=spec), method="comq_blocked")
    la, lb = _leaves(a["__qlayers__"]), _leaves(b["__qlayers__"])
    assert la.keys() == lb.keys() and len(la) == 14
    for k in la:
        for f in ("codes", "z_lo", "scale"):
            assert torch.equal(la[k][f], lb[k][f]), (k, f)
        assert la[k]["bits"] == lb[k]["bits"] == 4


def test_mixed_policy_matches_jax(mixed):
    """Per-leaf bits equal JAX's. Codes match as the uniform path's do:
    exactly where both packages solve the same Gram (layer 0's attn_in
    group, here 4/4/3 bits, solved leaf by leaf), and through the per-leaf
    errors (within ERR_RTOL) downstream, where the bf16 taps differ by
    rounding. No guard event."""
    (jq, jrep), (tq, trep) = mixed
    jl = _leaves(jax.device_get(jq["__qlayers__"]))
    tl = _leaves(tq["__qlayers__"])
    assert {k: v["bits"] for k, v in tl.items()} == \
        {k: int(v["bits"]) for k, v in jl.items()}
    assert tl["0.mlp.w_down"]["bits"] == 8 and tl["1.attn.wk"]["bits"] == 2
    assert tl["1.mlp.w_gate"]["bits"] == 3 and tl["0.attn.wq"]["bits"] == 4
    assert int(tl["0.mlp.w_down"]["codes"].max()) > 15
    for k in ("0.attn.wq", "0.attn.wk", "0.attn.wv"):
        np.testing.assert_array_equal(tl[k]["codes"].numpy(),
                                      np.asarray(jl[k]["codes"]), err_msg=k)
        np.testing.assert_allclose(tl[k]["scale"].numpy(),
                                   np.asarray(jl[k]["scale"]), rtol=1e-5,
                                   err_msg=k)
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        assert tr.guard == jr.guard == ""
    assert trep.guard_events == [] and jrep.guard_events == []
    assert trep.total_improvement() >= 0.3


def _serve_f32(qparams):
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    return cfg, BuildPlan(cache_dtype=torch.float32), \
        serving_params(qparams, cfg), materialize(qparams, cfg)


@pytest.mark.parametrize("cache_quant", [False, True])
def test_mixed_packed_decode_equals_materialized(mixed, cache_quant):
    """A model whose leaves mix codes packed 1, 2 and 4 per byte decodes
    from its packed codes exactly as from the dequantized weights (f32,
    bf16 and int8 static caches alike)."""
    _, (tq, _) = mixed
    cfg, plan, sp, mat = _serve_f32(tq)
    cpb = {(i, m, l): q.cpb for i, lp in enumerate(sp["layers"])
           for m, d in lp.items() if isinstance(d, dict)
           for l, q in d.items() if hasattr(q, "cpb")}
    assert set(cpb.values()) == {1, 2, 4}
    assert cpb[(0, "mlp", "w_down")] == 1 and cpb[(1, "attn", "wk")] == 4
    assert cpb[(0, "attn", "wv")] == 2
    plan = plan.replace(prefill_cache_len=20, cache_quant=cache_quant)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16))).long()
    with torch.no_grad():
        lq, cq = tm.prefill(sp, cfg, plan, tok)
        lm, cm = tm.prefill(mat, cfg, plan, tok)
        np.testing.assert_allclose(lq.numpy(), lm.numpy(), atol=1e-5)
        for i in range(3):
            gq, cq = tm.decode_step(sp, cfg, plan, cq, tok[:, i:i + 1],
                                    16 + i)
            gm, cm = tm.decode_step(mat, cfg, plan, cm, tok[:, i:i + 1],
                                    16 + i)
            np.testing.assert_allclose(gq.numpy(), gm.numpy(), atol=1e-5)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_mixed_packed_serve_matches_materialized_tokens(mixed, kv_bits):
    """serve.Runtime on the packed mixed model gives the materialized
    model's greedy tokens; a cache_quant plan serves int8 pages."""
    from repro_torch.serve import Runtime, ServeConfig
    _, (tq, _) = mixed
    cfg, plan, sp, mat = _serve_f32(tq)
    plan = (plan.replace(cache_quant=True) if kv_bits == 8
            else plan.replace(kv_bits=kv_bits))
    prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, (n,))
               for s, n in ((1, 12), (2, 9))]

    def rt(p):
        return Runtime(p, cfg, plan, ServeConfig(
            max_slots=2, block_size=8, num_blocks=16, buckets=(16,),
            max_blocks_per_slot=4), device="cpu")

    r = rt(sp)
    assert r.kv_bits == kv_bits and not r.plan.cache_quant
    for a, b in zip(r.generate(prompts, max_new_tokens=8),
                    rt(mat).generate(prompts, max_new_tokens=8)):
        np.testing.assert_array_equal(a, b)


def test_qpk_carries_the_policy(mixed, tmp_path):
    """save_packed_ckpt(**policy_extra(...)) stores the policy; both
    packages' loaders give it back, and the per-leaf widths survive."""
    from repro_torch.ckpt import unpack_tree
    from repro_torch.convert import qparams_from_numpy
    _, (tq, _) = mixed
    pol = QuantPolicy(base=QuantSpec(**SPEC), rules=RULES, kv_bits=8)
    path = str(tmp_path / "mixed.qpk")
    save_packed_ckpt(path, pack_tree({"__qlayers__": tq["__qlayers__"]}),
                     **policy_extra(policy=pol, arch=ARCH, bits=4))
    got = load_packed_ckpt(path)
    assert got["arch"] == ARCH and restore_policy(got) == pol
    assert restore_policy({"arch": ARCH}) is None
    jp = jax_restore_policy(jax_load(path))
    assert jp == JPolicy(base=JSpec(**SPEC), rules=RULES, kv_bits=8)
    packed = got["tree"]["__qlayers__"]
    assert packed["1"]["attn"]["wk"]["packed_cpb"] == 4
    assert "packed_cpb" not in packed["0"]["mlp"]["w_down"]
    restored = _leaves(unpack_tree(qparams_from_numpy(got["tree"], "cpu"))[
        "__qlayers__"])
    for k, v in _leaves(tq["__qlayers__"]).items():
        assert torch.equal(restored[k]["codes"], v["codes"]), k
        assert restored[k]["bits"] == v["bits"]


# ---------------------------------------------------------------------------
# the legacy schedule, the X-space solver, GramAccumulator
# ---------------------------------------------------------------------------

def test_legacy_schedule_matches_jax(jparams, tokens):
    """propagation="legacy": a float tap forward, the layer's solves, a
    second forward through the quantized layer — codes and per-leaf
    errors against JAX's legacy run."""
    _, jrep = _warnless(jax_quantize, jparams, jax_cfg(ARCH),
                        JPlan(remat=False), jnp.asarray(tokens),
                        JSpec(**SPEC), method="comq_blocked",
                        propagation="legacy")
    tq, trep = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                         get_smoke_config(ARCH), BuildPlan(),
                         torch.from_numpy(tokens).long(), QuantSpec(**SPEC),
                         method="comq_blocked", propagation="legacy")
    for jr, tr in zip(jrep.layers, trep.layers):
        assert (tr.layer, tr.name) == (jr.layer, jr.name)
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    staged, _ = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                          get_smoke_config(ARCH), BuildPlan(),
                          torch.from_numpy(tokens).long(), QuantSpec(**SPEC),
                          method="comq_blocked")
    # layer 0's first tap group sees the same input either way
    a = _leaves(tq["__qlayers__"])["0.attn.wq"]["codes"]
    b = _leaves(staged["__qlayers__"])["0.attn.wq"]["codes"]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="propagation"):
        quantize_model(params_from_numpy(jparams, "cpu"),
                       get_smoke_config(ARCH), BuildPlan(),
                       torch.from_numpy(tokens).long(), QuantSpec(**SPEC),
                       propagation="eager")


@pytest.mark.parametrize("gran", ["per_channel", "per_layer"])
@pytest.mark.parametrize("order", ["cyclic", "greedy"])
def test_xspace_comq_error_trajectory_matches_jax(gran, order):
    """The row-at-a-time X-space solver flips codes across FP fusion
    contexts (ROADMAP Queue C), so it is held on its error trajectory:
    within 2% of JAX's at every sweep, and falling."""
    from repro.core.comq import comq_quantize as jax_comq
    from repro_torch.core import comq_quantize
    rs = np.random.RandomState(7)
    x = rs.randn(256, 48).astype(np.float32)
    w = rs.randn(48, 24).astype(np.float32)
    spec = dict(bits=3, granularity=gran, lam=0.9, sweeps=3, order=order)
    want = jax_comq(jnp.asarray(x), jnp.asarray(w), JSpec(**spec))
    got = comq_quantize(torch.from_numpy(x), torch.from_numpy(w),
                        QuantSpec(**spec))
    want_e = np.asarray(want.errors)
    # errors[0] is the float init's error, rounding noise around 0
    np.testing.assert_allclose(got.errors.numpy(), want_e, rtol=2e-2,
                               atol=1e-4 * want_e[1])
    assert float(got.errors[-1]) < float(got.errors[1])
    assert got.q.dtype == torch.int32 and got.q.shape == (48, 24)
    assert bool((got.q >= got.z_lo).all()) and bool((got.q <= got.z_hi).all())


def test_gram_accumulator_matches_jax():
    from repro.core.calibrate import GramAccumulator as JAcc
    from repro_torch.core import GramAccumulator
    rs = np.random.RandomState(2)
    batches = [rs.randn(2, 8, 12).astype(np.float32) for _ in range(3)]
    ta, ja = GramAccumulator(12, device="cpu"), JAcc(12)
    for b in batches:
        assert ta.update(torch.from_numpy(b)) is ta
        ja.update(jnp.asarray(b))
    assert ta.count == ja.count == 48
    np.testing.assert_allclose(ta.value().numpy(), np.asarray(ja.value()),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fake_quantize_params and the int8 static cache
# ---------------------------------------------------------------------------

def test_fake_quantize_params_matches_jax(jparams):
    """RTN codes in QT leaves, embed included, as JAX lays them out; the
    fused-layout leaves decode through quant_matmul."""
    from repro.core.apply import fake_quantize_params as jax_fake
    from repro_torch.core.apply import fake_quantize_params, is_qt
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    p = params_from_numpy(jparams, "cpu")
    fq = fake_quantize_params(p, cfg, BuildPlan(), bits=4)
    jfq = jax_fake(jparams, jax_cfg(ARCH), JPlan(remat=False), bits=4)
    pairs = [(fq["embed"], jfq["embed"]), (fq["unembed"], jfq["unembed"])]
    for l, lp in enumerate(fq["layers"]):
        for mod in ("attn", "mlp"):
            for leaf, q in lp[mod].items():
                if is_qt(q):
                    j = jfq["layers"][mod][leaf]
                    pairs.append((q, type(j)(j.codes[l], j.scale[l],
                                             j.z_lo[l], j.shape[1:], j.bits,
                                             cpb=j.cpb)))
    assert len(pairs) == 2 + 7 * cfg.n_layers
    for q, j in pairs:
        assert (q.shape, q.bits, q.cpb) == (tuple(j.shape), j.bits, j.cpb)
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(j.scale))
        np.testing.assert_array_equal(q.z_lo.numpy(), np.asarray(j.z_lo))
    no_embed = fake_quantize_params(p, cfg, BuildPlan(), quantize_embed=False)
    assert not is_qt(no_embed["embed"]) and is_qt(no_embed["unembed"])
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8))).long()
    plan = BuildPlan(cache_dtype=torch.float32, prefill_cache_len=9)
    with torch.no_grad():
        _, cache = tm.prefill(fq, cfg, plan, tok)
        got, _ = tm.decode_step(fq, cfg, plan, cache, tok[:, :1], 8)
        dense = {**fq, "embed": fq["embed"].dequant(torch.float32),
                 "unembed": fq["unembed"].dequant(torch.float32),
                 "layers": [{k: ({n: (w.dequant(torch.float32) if is_qt(w)
                                      else w) for n, w in v.items()}
                                 if isinstance(v, dict) else v)
                             for k, v in lp.items()} for lp in fq["layers"]]}
        _, cache = tm.prefill(dense, cfg, plan, tok)
        want, _ = tm.decode_step(dense, cfg, plan, cache, tok[:, :1], 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_q8_kv_codes_and_scales_equal_jax():
    rs = np.random.RandomState(5)
    x = (rs.randn(2, 7, 3, 16) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                         # absmax 0: scale 1
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 127.0 / 127 * 2.5]
    q, s = tattn._q8_kv(torch.from_numpy(x))
    jq, js = jattn._q8_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and float(s[0, 0, 0]) == 1.0
    np.testing.assert_array_equal(
        tattn._dq8_kv(q, s, torch.float32).numpy(),
        np.asarray(jattn._dq8_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("window", [0, 16])
def test_int8_static_cache_decode_matches_jax(jparams, window):
    """plan.cache_quant: prefill writes int8 codes + per-entry scales,
    decode inserts and dequantizes; f32 logits against JAX's within the
    model parity tolerance (1e-4, tests/test_torch_model.py). A 16-token
    sliding window under a 24-token prompt runs the cache as a ring."""
    T = 24
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32",
                                         sliding_window=window)
    jcfg = jax_cfg(ARCH).replace(compute_dtype="float32",
                                 sliding_window=window)
    plan = BuildPlan(cache_dtype=torch.float32, cache_quant=True,
                     prefill_cache_len=0 if window else T + 3)
    jplan = JPlan(remat=False, cache_dtype=jnp.float32, cache_quant=True,
                  prefill_cache_len=plan.prefill_cache_len)
    p = params_from_numpy(jparams, "cpu")
    tok = np.random.default_rng(window).integers(
        0, cfg.vocab_size, (2, T + 3)).astype(np.int32)
    with torch.no_grad():
        lt, ct = tm.prefill(p, cfg, plan, torch.from_numpy(tok[:, :T]).long())
    lj, cj = jm.prefill(jparams, jcfg, jplan, jnp.asarray(tok[:, :T]))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    kv = ct["kv"][0]
    assert kv.k.dtype == torch.int8
    assert kv.k_scale.shape == (2, window or T + 3, cfg.n_kv_heads)
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(cj["kv"].pos[0]))
    for i in range(3):
        nxt = tok[:, T + i:T + i + 1]
        with torch.no_grad():
            lt, ct = tm.decode_step(p, cfg, plan, ct,
                                    torch.from_numpy(nxt).long(), T + i)
        lj, cj = jm.decode_step(jparams, jcfg, jplan, cj, jnp.asarray(nxt),
                                jnp.int32(T + i))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(ct["kv"][1].k.numpy(),
                                  np.asarray(cj["kv"].k[1]))
    cache = tm.init_cache(cfg, plan, 2, 16, device="cpu")
    assert cache["kv"][0].k.dtype == torch.int8
    assert cache["kv"][0].v_scale.dtype == torch.float32


# ---------------------------------------------------------------------------
# the launcher's policy flags
# ---------------------------------------------------------------------------

JAX_SUMMARY_KEYS = [
    "arch", "method", "bits", "mixed_policy", "bits_budget", "propagation",
    "data_shards", "model_shards", "order", "granularity",
    "layers_quantized", "comq_vs_rtn_error_improvement", "fp_loss",
    "quant_loss", "seconds", "ckpt_bytes", "dense_bytes", "compression",
    "guard_events", "resumed_leaves", "faults_fired"]


@pytest.mark.parametrize("flags,want", [
    (["--policy", "0.mlp.w_down=8,1.attn.wk=2,1.mlp.w_gate=3,kv=8"],
     dict(mixed_policy=True, bits_budget=None, propagation="staged")),
    (["--bits-budget", "3.5", "--policy", "kv=4,*.w_down=8"],
     dict(mixed_policy=True, bits_budget=3.5, propagation="staged")),
    (["--no-guards"], dict(mixed_policy=False, bits_budget=None,
                           propagation="staged")),
    (["--propagation", "legacy", "--policy", "first=8"],
     dict(mixed_policy=True, bits_budget=None, propagation="legacy")),
])
def test_launcher_policy_flags(flags, want, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launcher.main(["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                       "--calib-batch", "2", "--calib-seq", "48",
                       "--device", "cpu"] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert list(out) == JAX_SUMMARY_KEYS
    assert {k: out[k] for k in want} == want
    assert out["guard_events"] == 0 and out["layers_quantized"] == 14
    assert out["comq_vs_rtn_error_improvement"] > 0.2
    if "--bits-budget" in flags:
        assert lines[0].startswith("# note: --bits-budget supersedes")
        assert lines[1].startswith("# bit allocation under 3.5 bits/param")


def test_launcher_kv_rider_sets_the_plan(jparams):
    """kv=8 turns on the int8 static cache and int8 pages, kv=4 4-bit
    pages only; other widths are refused."""
    from repro_torch.launch.quantize import resolve_policy
    cfg = get_smoke_config(ARCH)
    p = params_from_numpy(jparams, "cpu")
    tok = torch.zeros(1, 8, dtype=torch.long)
    base = QuantSpec(**SPEC)
    _, plan, _, _ = resolve_policy(p, cfg, BuildPlan(), tok, base, "kv=8")
    assert plan.cache_quant and plan.kv_bits == 8
    _, plan, _, _ = resolve_policy(p, cfg, BuildPlan(), tok, base, "kv=4")
    assert not plan.cache_quant and plan.kv_bits == 4
    spec, plan, _, _ = resolve_policy(p, cfg, BuildPlan(), tok, base, None)
    assert spec is base and plan == BuildPlan()
    with pytest.raises(ValueError, match="kv=2"):
        resolve_policy(p, cfg, BuildPlan(), tok, base, "kv=2")
