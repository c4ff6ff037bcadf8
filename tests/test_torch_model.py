"""The port's dense model against the JAX model on qwen2-7b smoke, both
running the JAX init converted through numpy (repro_torch.convert):
forward logits and activation taps, and prefill + teacher-forced decode
from packed codes (the JAX quantize_model output converted); the same two
checks on the smoke configs of the other dense archs (deepseek-67b,
mistral-large-123b, h2o-danube-1.8b with its sliding window)."""
import functools

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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core.apply import serving_params
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ARCH = "qwen2-7b"
DENSE_CONFIGS = ["deepseek-67b", "mistral-large-123b", "h2o-danube-1.8b"]


def assert_close(got, want, cd, what=""):
    """f32: the same math in other summation orders and transcendental
    implementations. bf16: the two frameworks round activations to bf16 at
    different places (the JAX attention also rounds its probabilities to
    bf16), and a flipped rounding compounds over the layers; values here are
    |x| <~ 3 (bf16 ulp 1/64), so allow 8 ulps anywhere and a mean error of
    about one ulp at |x| ~ 2. (At f32 the same runs agree to ~3e-5.)"""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if cd == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
        return
    err = np.abs(got - want)
    assert err.max() <= 0.125, (what, float(err.max()))
    assert err.mean() <= 2e-2, (what, float(err.mean()))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(arch),
                                   JPlan(remat=False)))


@pytest.fixture(scope="module")
def jparams():
    return _jparams(ARCH)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_logits_and_taps_match_jax(jparams, cd):
    _check_forward(jparams, ARCH, cd)


def _check_forward(jparams, arch, cd):
    jc = jax_cfg(arch).replace(compute_dtype=cd)
    tc = get_smoke_config(arch).replace(compute_dtype=cd)
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
    assert list(ttaps) == list(jtaps)
    for name in jtaps:
        assert tuple(ttaps[name].shape) == tuple(jtaps[name].shape), name
        assert_close(ttaps[name].float().numpy(), jtaps[name], cd, name)


@functools.lru_cache(maxsize=None)
def _jax_rtn(arch):
    # RTN codes: the point here is decoding from packed codes, and RTN keeps
    # the JAX solve out of this test's time (test_torch_pipeline compares
    # the comq_blocked solves)
    spec = JSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
                 order="greedy")
    jq, _ = jax_quantize(_jparams(arch), jax_cfg(arch), JPlan(remat=False),
                         jnp.asarray(_tokens(2, (2, 80))), spec,
                         method="rtn", guards=False)
    return jq


@pytest.fixture(scope="module")
def jax_qparams(jparams):
    return _jax_rtn(ARCH)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_from_packed_codes_match_jax(jax_qparams, cd):
    _check_decode(jax_qparams, ARCH, cd)


@pytest.mark.parametrize("arch", DENSE_CONFIGS)
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dense_configs_forward_and_decode_match_jax(arch, cd):
    """The other dense archs need only their config files: forward logits
    and taps, and decode from packed codes, as qwen2-7b's above."""
    _check_forward(_jparams(arch), arch, cd)
    _check_decode(_jax_rtn(arch), arch, cd)


def _check_decode(jax_qparams, arch, cd):
    jc = jax_cfg(arch).replace(compute_dtype=cd)
    tc = get_smoke_config(arch).replace(compute_dtype=cd)
    tq = qparams_from_numpy(jax.device_get(jax_qparams), "cpu")
    jsp, tsp = jax_serving(jax_qparams, jc), serving_params(tq, tc)
    prompt, steps = _tokens(3, (2, 16)), 4
    # the f32 run keeps an f32 cache: a bf16 cache would round 1e-7 f32
    # differences in k/v across bf16 boundaries
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
