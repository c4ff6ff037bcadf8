"""The port's audio decoder (musicgen-large smoke: 2 layers, d 64, 4/4
heads of 16, layernorm, a plain GELU MLP, vocab 128) against the JAX
package, both on the JAX init converted through numpy: forward logits and
taps, decode from packed codes, quantize_model's codes and errors, the
paged Runtime's tokens at kv_bits 0 and 8, and both launchers. The family
needs no code of its own beyond layernorm: JAX treats it as dense."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as jax_quantize
from repro.core.apply import serving_params as jax_serving
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core import pipeline as tpl
from repro_torch.core.apply import serving_params
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

ARCH = "musicgen-large"
VOCAB = 128
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
ERR_RTOL = 0.05      # per-leaf errors downstream of layer 0's first group


def _warnless(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 96 calibration tokens < d_ff
        return fn(*a, **k)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


@pytest.fixture(scope="module")
def jax_qparams(jparams):
    jq, _ = _warnless(jax_quantize, jparams, jax_cfg(ARCH),
                      JPlan(remat=False), jnp.asarray(_tokens(2, (2, 80))),
                      JSpec(**SPEC), method="rtn", guards=False)
    return jax.device_get(jq)


def test_config_and_family():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.act, cfg.norm_type) == (
        "audio", 48, 2048, 32, 32, 64, 8192, 2048, "gelu_mlp", "layernorm")
    tt.check_ported(cfg)
    tt.check_paged(cfg)
    p = tm.init_params(get_smoke_config(ARCH), seed=0, device="cpu")
    assert sorted(p["layers"][0]["mlp"]) == ["w_down", "w_up"]
    assert sorted(p["layers"][0]["ln1"]) == sorted(p["final_norm"]) == [
        "bias", "scale"]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_and_taps_match_jax(jparams, cd):
    """Logits and every tap of layer 0 (f32 within 1e-4; bf16 under the
    dense test's bound)."""
    jc = jax_cfg(ARCH).replace(compute_dtype=cd)
    tc = get_smoke_config(ARCH).replace(compute_dtype=cd)
    tok = _tokens(1, (2, 24))
    tp = params_from_numpy(jparams, "cpu")
    jl = np.asarray(jm.forward(jparams, jc, JPlan(remat=False),
                               jnp.asarray(tok))[0], np.float32)
    with torch.no_grad():
        tl = tm.forward(tp, tc, BuildPlan(), torch.from_numpy(tok).long())[0]
    assert_close(tl.float().numpy(), jl, cd, "logits")
    jtaps, ttaps = {}, {}
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    jx = jm.embed_tokens(jparams, jc, JPlan(), jnp.asarray(tok))
    jt.layer_full(lp0, jx, jc, JPlan(remat=False), False, taps=jtaps)
    with torch.no_grad():
        tx = tm.embed_tokens(tp, tc, BuildPlan(), torch.from_numpy(tok))
        tt.layer_full(tp["layers"][0], tx, tc, BuildPlan(), False,
                      taps=ttaps)
    assert list(ttaps) == list(jtaps) == ["attn_in", "wo_in", "mlp_in",
                                          "down_in"]
    for name in jtaps:
        assert_close(ttaps[name].float().numpy(), jtaps[name], cd, name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_from_packed_codes_match_jax(jax_qparams, cd):
    """Prefill of 16 tokens and 4 teacher-forced steps from packed codes
    (wq..w_down through quant_matmul's plain version here)."""
    jc = jax_cfg(ARCH).replace(compute_dtype=cd)
    tc = get_smoke_config(ARCH).replace(compute_dtype=cd)
    jsp = jax_serving(jax_qparams, jc)
    tsp = serving_params(qparams_from_numpy(jax_qparams, "cpu"), tc)
    assert type(tsp["layers"][0]["mlp"]["w_up"]).__name__ == "QT"
    prompt, steps = _tokens(3, (2, 16)), 4
    jplan = JPlan(remat=False, prefill_cache_len=20,
                  cache_dtype=jnp.dtype(cd))
    tplan = BuildPlan(prefill_cache_len=20, cache_dtype=getattr(torch, cd))
    jl, jcache = jm.prefill(jsp, jc, jplan, jnp.asarray(prompt))
    with torch.no_grad():
        tl, tcache = tm.prefill(tsp, tc, tplan,
                                torch.from_numpy(prompt).long())
        for i in range(steps + 1):
            assert_close(tl.float().numpy(), jl, cd, f"step {i}")
            if i == steps:
                break
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jcache = jm.decode_step(jsp, jc, jplan, jcache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.int32(16 + i))
            tl, tcache = tm.decode_step(tsp, tc, tplan, tcache,
                                        torch.from_numpy(tok[:, None]).long(),
                                        16 + i)


def test_quantize_matches_jax(jparams):
    """Staged comq_blocked: layer 0's attn_in group (wq, wk, wv on the
    layernorm output) has JAX's codes bit for bit; every leaf's errors
    within ERR_RTOL; improvement > 0."""
    tok = _tokens(0, (2, 48))
    jq, jrep = _warnless(jax_quantize, jparams, jax_cfg(ARCH),
                         JPlan(remat=False), jnp.asarray(tok), JSpec(**SPEC),
                         method="comq_blocked", guards=False)
    tq, trep = _warnless(quantize_model, params_from_numpy(jparams, "cpu"),
                         get_smoke_config(ARCH), BuildPlan(),
                         torch.from_numpy(tok).long(), QuantSpec(**SPEC),
                         method="comq_blocked")
    jq = jax.device_get(jq)
    for leaf in ("wq", "wk", "wv"):
        t = tq["__qlayers__"]["0"]["attn"][leaf]
        j = jq["__qlayers__"]["0"]["attn"][leaf]
        np.testing.assert_array_equal(t["codes"].numpy(),
                                      np.asarray(j["codes"]), err_msg=leaf)
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    assert len(trep.layers) == 2 * 6          # wq wk wv wo w_up w_down
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    assert trep.total_improvement() > 0 and not trep.guard_events
    assert tpl.taps_for(get_smoke_config(ARCH)) == tpl.DENSE_TAPS


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
def test_runtime_tokens_match_jax_mixed_staggered(jax_qparams, kv_bits):
    """The paged Runtime from packed codes at f32 (group 1: MHA), mixed
    lengths and staggered arrivals: JAX's runtime tokens, and each
    request's solo tokens."""
    from repro.serve import Runtime as JRuntime
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import Runtime, ServeConfig
    jcfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (5, 16, 11, 8)]
    jrt = JRuntime(jax_serving(jax_qparams, jcfg), jcfg,
                   JPlan(remat=False, cache_dtype=jnp.float32,
                         kv_bits=kv_bits), JServeConfig(**SC))
    want = _staggered(jrt, prompts)
    sp = serving_params(qparams_from_numpy(jax_qparams, "cpu"), cfg)
    plan = BuildPlan(cache_dtype=torch.float32, kv_bits=kv_bits)
    with torch.no_grad():
        got = _staggered(Runtime(sp, cfg, plan, ServeConfig(**SC),
                                 device="cpu"), prompts)
        solo_rt = Runtime(sp, cfg, plan, ServeConfig(**SC), device="cpu")
        solo = [solo_rt.generate([p], max_new_tokens=6)[0].tolist()
                for p in prompts]
    assert got == want
    assert got == solo


def test_launchers_run_musicgen(capsys):
    from repro_torch.launch import quantize as launch_quantize
    from repro_torch.launch import serve as launch_serve
    s = _warnless(launch_quantize.main,
                  ["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                   "--calib-batch", "2", "--calib-seq", "48", "--device",
                   "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
    assert s["arch"] == "musicgen-large-smoke" and s["layers_quantized"] == 12
    assert s["comq_vs_rtn_error_improvement"] > 0.3
    assert abs(s["quant_loss"] - s["fp_loss"]) <= 0.15
    out = _warnless(launch_serve.main,
                    ["--arch", ARCH, "--smoke", "--quantize",
                     "--num-requests", "3", "--prompt-len", "12",
                     "--max-new", "4", "--mixed", "--stagger", "2",
                     "--kv-bits", "4", "--device", "cpu"])
    assert out["engine"] == "paged" and out["kv_bits"] == 4
    assert out["packed_qt"] and out["finish_reasons"] == ["length"] * 3
