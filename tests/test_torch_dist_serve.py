"""The slot+page-sharded paged runtime: `Runtime(mesh=)` on 4 gloo ranks
(model 4) with JAX's sharded-serving traffic (tests/test_kv_quant.py:
four prompts of 9/14/7/12 tokens, 16 pages of 8, 4 slots, 8 new tokens,
f32) gives the meshless port runtime's greedy tokens and JAX's meshless
runtime's, at int8 pages and at f32 pages. Each rank holds 4 pages; no
collective runs inside `decode_step_paged`, and one token gather follows
each step. A journaled sharded run killed at its 4th step on every rank
and recovered through `recover_runtime(mesh=)` gives the same tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import spawn

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SC = dict(max_slots=4, block_size=8, num_blocks=16, buckets=(8, 16),
          max_blocks_per_slot=4)
KV_BITS = (8, 0)
MAX_NEW = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_smoke_config as jcfg
    from repro.models import BuildPlan as JPlan
    from repro.models import init_params as jinit
    from repro.serve import Runtime as JRuntime
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Runtime, ServeConfig
    cfg = jcfg(ARCH).replace(compute_dtype="float32")
    jparams = jax.device_get(jinit(jax.random.PRNGKey(0), cfg,
                                   JPlan(remat=False)))
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (9, 14, 7, 12)]
    port = spawn("serve", {"arch": ARCH, "cfg": {"compute_dtype": "float32"},
                           "params": jparams, "prompts": prompts, "sc": SC,
                           "kv_bits": KV_BITS, "max_new": MAX_NEW,
                           "cache_dtype": "float32",
                           "kill_dir": str(tmp_path_factory.mktemp("jd"))},
                 4, tmp_path_factory.mktemp("dist_serve"))
    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    tparams = params_from_numpy(jparams, "cpu")
    jax_toks, port_toks = {}, {}
    for kv in KV_BITS:
        jplan = JPlan(remat=False, cache_dtype=jnp.float32, kv_bits=kv)
        jax_toks[kv] = [t.tolist() for t in JRuntime(
            jparams, cfg, jplan, JServeConfig(**SC)).generate(
                prompts, max_new_tokens=MAX_NEW)]
        port_toks[kv] = [t.tolist() for t in Runtime(
            tparams, tcfg, BuildPlan(cache_dtype=torch.float32, kv_bits=kv),
            ServeConfig(**SC), device="cpu").generate(
                prompts, max_new_tokens=MAX_NEW)]
    return port, jax_toks, port_toks


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_sharded_runtime_tokens_equal_meshless_and_jax(runs, kv_bits):
    port, jax_toks, port_toks = runs
    assert port_toks[kv_bits] == jax_toks[kv_bits]
    for r in port:                    # every rank's host state is the same
        assert r[kv_bits]["tokens"] == port_toks[kv_bits]
        assert all(len(t) == MAX_NEW for t in r[kv_bits]["tokens"])


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_decode_step_issues_no_collective(runs, kv_bits):
    port, _, _ = runs
    for r in port:
        c = r[kv_bits]["counts"]
        assert c["steps"] > 0
        assert c["inside"] == 0, c
        assert c["outside"] == c["steps"], c     # one token gather a step
        assert r[kv_bits]["pool_blocks"] == SC["num_blocks"] // 4


def test_killed_sharded_runtime_recovers_the_uninterrupted_tokens(runs):
    port, _, port_toks = runs
    for r in port:
        rec = r["recovered"]
        assert rec["killed"] and len(rec["inflight"]) == 4
        assert rec["tokens"] == port_toks[KV_BITS[0]]
