"""The prefill programs as one compiled program per signature, on the CPU:
the paged Runtime's prefill buckets (`serve.prefill[bucket]`) and prefill
writes (`serve.prefill_write[cache_len]`), and the static Engine's
prefill (`serve.engine.prefill`), each through `analysis.retrace.
guard_graph` (JAX's `guard_jit`).

On the CPU a guard_graph runs its program eagerly through the static
buffers the card's graph reads, and refuses at a signature's first call
what a capture refuses (a host read, `nonzero`, a boolean-mask index).
These tests hold the fixed-shape `write_prefill` to the `nonzero` write it
replaced (a copy kept here as its oracle) bit for bit, the Runtime's
tokens to JAX's on staggered traffic that preempts and resumes through
an `extend=` bucket (a resume and a fresh request admitted in one step),
the Engine's tokens to JAX's (dense, hybrid, rwkv; the VLM's to the
port's eager prefill), one signature a bucket, cache length and batch
shape, and the lint over the capture sites. Smoke configs at 2 layers
(the VLM one group of 5), f32. The card's side (a replayed prefill and
write against a direct call bit for bit) is in test_torch_cuda.py.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.serve import Runtime as JRuntime
from repro.serve import ServeConfig as JServeConfig
from repro.serve.engine import Engine as JEngine
from repro_torch.analysis import lint
from repro_torch.analysis.retrace import (compile_count, guard_graph,
                                          reset_guards)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import BuildPlan, decode_step, init_params, prefill
from repro_torch.serve import Engine, Runtime, ServeConfig
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import runtime as runtime_mod
from repro_torch.serve import kv_cache
from repro_torch.serve.kv_cache import kv_encode, kv_scale_of

torch.set_num_threads(2)

VLM = "llama-3.2-vision-90b"


def _nonzero_write(pool, k_seq, v_seq, pos_row, table_row, kv_bits=0):
    """The write before it took fixed shapes: the kept rows selected with
    `nonzero` (a host read), then scattered; the fixed-shape write's
    oracle."""
    k_pool, v_pool = pool["k"], pool["v"]
    L, NB, BS = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    rows = torch.nonzero(pos_row >= 0).flatten()
    pos = pos_row[rows].long()
    phys = table_row.long()[pos // BS]
    dest = phys * BS + pos % BS
    if not kv_bits:
        for cpool, seq in ((k_pool, k_seq), (v_pool, v_seq)):
            flat = cpool.view(L, NB * BS, *cpool.shape[3:])
            flat[:, dest] = seq[:, rows].to(cpool.dtype)
        return pool
    touched = torch.zeros(NB, dtype=torch.bool, device=k_pool.device)
    touched[phys] = True
    for name, cpool, seq in (("k", k_pool, k_seq), ("v", v_pool, v_seq)):
        KV = cpool.shape[3]
        r = seq[:, rows].float()
        absmax = r.abs().amax(dim=-1)
        pmax = torch.zeros(L, NB, KV, dtype=torch.float32,
                           device=cpool.device)
        idx = phys[None, :, None].expand(L, -1, KV)
        pmax.scatter_reduce_(1, idx, absmax, reduce="amax")
        scale = pool[name + "_scale"]
        new_scale = torch.where(touched[None, :, None],
                                kv_scale_of(pmax, kv_bits), scale)
        codes = kv_encode(r, new_scale[:, phys], kv_bits)
        flat = cpool.view(L, NB * BS, *cpool.shape[3:])
        flat[:, dest] = codes
        scale.copy_(new_scale)
    return pool


# cache positions (S = 8 rows, pages of 4) and the true length: a prefix
# with right-pad rows; a sliding-window ring that wrapped (positions 8-10
# in rows 0-2, over the first lap's 0-2; row 3 unwritten; 4-7 in rows
# 4-7); no valid row at all
WRITE_CASES = {
    "prefix": ([0, 1, 2, 3, 4, 5, 6, 7], 6),
    "ring": ([8, 9, 10, -1, 4, 5, 6, 7], 10 ** 6),
    "none": ([-1] * 8, 10 ** 6),
}


def _random_pool(kv_bits, gen, L=2, NB=6, BS=4, KV=2, hd=8):
    """A pool whose pages hold earlier requests' bytes (codes and scales),
    so a write that touches a page it should not shows."""
    if not kv_bits:
        shape = (L, NB, BS, KV, hd)
        return {n: torch.randn(shape, generator=gen).to(torch.bfloat16)
                for n in ("k", "v")}
    hi, dt = (127, torch.int8) if kv_bits == 8 else (255, torch.uint8)
    shape = (L, NB, BS, KV, hd // (1 if kv_bits == 8 else 2))
    pool = {n: torch.randint(0 if kv_bits == 4 else -hi, hi + 1, shape,
                             generator=gen).to(dt) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        pool[n] = torch.rand((L, NB, KV), generator=gen)
    return pool


@pytest.mark.parametrize("case", list(WRITE_CASES))
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_fixed_shape_write_equals_the_nonzero_write(kv_bits, case):
    """The Runtime's write program (the positions past tlen dropped, then
    the fixed-shape `write_prefill`), run through a guard_graph that
    refuses a host read, leaves the pool bit for bit as the nonzero write
    did: at kv_bits 0 (f32 rows into bf16 pages), 8 and 4, over a prefix
    with right-pad rows, a wrapped ring and a call with no valid row (a
    no-op)."""
    positions, tlen = WRITE_CASES[case]
    gen = torch.Generator().manual_seed(kv_bits + len(case))
    pool = _random_pool(kv_bits, gen)
    k_seq = torch.randn((2, 8, 2, 8), generator=gen) * 3
    v_seq = torch.randn((2, 8, 2, 8), generator=gen)
    kv_pos = torch.tensor(positions, dtype=torch.int32)
    table = torch.tensor([4, 1, 5, 0], dtype=torch.int32)
    start = {n: t.clone() for n, t in pool.items()}
    want = {n: t.clone() for n, t in pool.items()}
    _nonzero_write(want, k_seq, v_seq,
                   torch.where(kv_pos < tlen, kv_pos, -1), table, kv_bits)
    write = guard_graph(runtime_mod._write_rows, name=f"t.write.{case}",
                        per_signature=True, copy_argnums=(2, 3, 4, 5, 6),
                        device="cpu")
    out = write(pool, kv_bits, k_seq, v_seq, kv_pos,
                torch.tensor(tlen, dtype=torch.int64), table)
    assert out is pool
    for n in pool:
        assert torch.equal(pool[n], want[n]), n
    changed = any(not torch.equal(pool[n], start[n]) for n in pool)
    assert changed == (case != "none")
    if kv_bits:          # the pages no kept row writes keep their scales
        kept = {int(table[p // 4]) for p in positions if 0 <= p < tlen}
        for p in set(range(6)) - kept:
            assert torch.equal(pool["k_scale"][:, p], start["k_scale"][:, p])
    assert "nonzero" not in inspect.getsource(kv_cache.write_prefill)


# ---------------------------------------------------------------------------
# the Runtime: JAX's tokens, a resume through an extend= bucket admitted in
# the step a fresh request is
# ---------------------------------------------------------------------------

SC = dict(max_slots=2, block_size=8, num_blocks=5, buckets=(8, 16),
          max_blocks_per_slot=4)
PROMPTS = [(14, 8), (15, 9), (5, 6), (6, 4)]      # (length, max_new)


@pytest.fixture(scope="module")
def qwen():
    jc = jax_cfg("qwen2-7b").replace(compute_dtype="float32", n_layers=2)
    jp = jax_init(jax.random.PRNGKey(0), jc, JPlan(remat=False))
    cfg = get_smoke_config("qwen2-7b").replace(compute_dtype="float32",
                                               n_layers=2)
    return jc, jp, cfg, params_from_numpy(jax.device_get(jp), "cpu")


def _traffic(rt, prompts):
    """Two requests up front, the rest one a step, then drain: the two
    long ones outgrow the five pages, the later one is preempted and
    resumes (prompt + 5 emitted tokens past the last bucket) in the step
    the first retires, ahead of the fresh request queued behind it."""
    reqs = [rt.submit(p, max_new_tokens=n) for p, n in prompts[:2]]
    for p, n in prompts[2:]:
        for _ in range(6):
            rt.step()
        reqs.append(rt.submit(p, max_new_tokens=n))
    while not rt.scheduler.idle:
        rt.step()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_runtime_prefill_graphs_match_jax_with_a_resume(qwen, kv_bits):
    """Every prefill and write goes through its graph: the tokens are
    JAX's Runtime's, a resumed request re-prefills through an extend=
    bucket in the same step as a fresh admission that follows it, and
    each bucket and cache length has one signature."""
    jc, jp, cfg, params = qwen
    rs = np.random.RandomState(4)
    prompts = [(rs.randint(0, 256, (n,)).astype(np.int32), m)
               for n, m in PROMPTS]
    want = _traffic(JRuntime(jp, jc, JPlan(remat=False,
                                           cache_dtype=jnp.float32,
                                           kv_bits=kv_bits),
                             JServeConfig(**SC)), prompts)
    rt = Runtime(params, cfg, BuildPlan(cache_dtype=torch.float32,
                                        kv_bits=kv_bits),
                 ServeConfig(**SC), device="cpu")
    admits, real = [], rt._admit_one

    def admit(req):
        admits.append((rt.steps, bool(req.out_tokens),
                       rt.scheduler.bucket_for(
                           req.prompt_len + max(len(req.out_tokens) - 1, 0),
                           extend=True)))
        return real(req)
    rt._admit_one = admit
    with torch.no_grad():
        got = _traffic(rt, prompts)
    assert got == want
    assert rt.scheduler.preemptions >= 1
    by_step = {}
    for step, resume, bucket in admits:
        by_step.setdefault(step, []).append((resume, bucket))
    assert any(len(a) >= 2 and a[0] == (True, 32) and not a[1][0]
               for a in by_step.values()), by_step
    assert sorted(rt._prefills) == [8, 16, 32]
    assert sorted(rt._writes) == [8, 16, 32]
    for b in rt._prefills:
        assert compile_count(f"serve.prefill[{b}]") == 1
        assert compile_count(f"serve.prefill_write[{b}]") == 1
        assert len(rt._prefills[b].func.__comq_graphs__) == 1
        assert len(rt._writes[b].func.__comq_graphs__) == 1
    assert compile_count("serve.decode_step") == 1
    assert rt.graph_pool_bytes() == 0          # no graph on the CPU
    pools = {id(g.__comq_pool__) for g in (
        rt._decode, *(f.func for f in (*rt._prefills.values(),
                                       *rt._writes.values())))}
    assert pools == {id(rt._graph_pool)}       # one pool for all seven


def test_runtime_prefill_returns_the_row_it_reads(qwen):
    """The bucket's graph gathers the logits row at tlen - 1: the row of
    the whole bucket's logits (the forward called directly), bit for bit,
    with the cache rows and positions."""
    from repro_torch.models.model import forward
    _, _, cfg, params = qwen
    rt = Runtime(params, cfg, BuildPlan(cache_dtype=torch.float32),
                 ServeConfig(**SC), device="cpu")
    prompt = np.arange(11, dtype=np.int64) * 5 % 256
    with torch.no_grad():
        for _ in range(2):                # the capture's call, then a later
            last, k_seq, v_seq, pos, tlen = rt._prefill(prompt, 16)
        tokens = torch.zeros((1, 16), dtype=torch.int64)
        tokens[0, :11] = torch.as_tensor(prompt)
        logits, _, cache = forward(params, cfg, rt.plan.replace(
            prefill_cache_len=16), tokens, make_cache=True)
    assert int(tlen) == 11 and last.shape == (1, cfg.vocab_size)
    assert torch.equal(last, logits[:, 10])
    assert torch.equal(k_seq, torch.stack([c.k[0] for c in cache["kv"]]))
    assert torch.equal(v_seq, torch.stack([c.v[0] for c in cache["kv"]]))
    assert torch.equal(pos, cache["kv"][0].pos[0])
    assert compile_count("serve.prefill[16]") == 1


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

ENGINE_ARCHS = {"qwen2-7b": 2, "hymba-1.5b": 2, "rwkv6-7b": 2, VLM: 5}
PROMPT, NEW = 12, 5


def _engine_inputs(arch, vocab, T=PROMPT):
    rs = np.random.RandomState(8)
    prompts = rs.randint(0, vocab, (2, T)).astype(np.int32)
    ve = None
    if arch == VLM:
        ca = jax_cfg(VLM).cross_attn
        ve = rs.standard_normal((2, ca.n_vision_tokens,
                                 ca.vision_dim)).astype(np.float32)
    return prompts, ve


@pytest.mark.parametrize("arch", list(ENGINE_ARCHS))
def test_engine_prefill_graph_tokens(arch, monkeypatch):
    """The Engine's prefill through its graph: greedy tokens equal JAX's
    Engine's (dense, hybrid, rwkv from the same init), and for every
    family the prefill logits equal the eager prefill's bit for bit; one
    signature for two batches of one shape, a second for another
    prompt length, whose decode steps replay the one decode graph."""
    reset_guards("serve.engine.prefill")
    layers = ENGINE_ARCHS[arch]
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         n_layers=layers)
    if arch == VLM:
        params = init_params(cfg, seed=0, device="cpu")
        for cross in params["groups"]["cross"]:
            for name in ("gate_attn", "gate_mlp"):
                cross[name] = torch.full_like(cross[name], 0.5)
    else:
        jc = jax_cfg(arch).replace(compute_dtype="float32", n_layers=layers)
        jp = jax_init(jax.random.PRNGKey(0), jc, JPlan(remat=False))
        params = params_from_numpy(jax.device_get(jp), "cpu")
    prompts, ve = _engine_inputs(arch, cfg.vocab_size)
    plan = BuildPlan(cache_dtype=torch.float32)
    seen, real = [], engine_mod.sample

    def sample(logits, *a, **k):
        seen.append(logits.clone())
        return real(logits, *a, **k)
    monkeypatch.setattr(engine_mod, "sample", sample)
    with torch.no_grad():
        eng = Engine(params, cfg, plan, max_len=PROMPT + NEW, device="cpu")
        got = eng.generate_batch(prompts, max_new_tokens=NEW,
                                 vision_embeds=ve)
        again = eng.generate_batch(prompts, max_new_tokens=NEW,
                                   vision_embeds=ve)
        assert compile_count("serve.engine.prefill") == 1
        short, _ = _engine_inputs(arch, cfg.vocab_size, T=PROMPT - 3)
        eng.generate_batch(short, max_new_tokens=NEW, vision_embeds=ve)
        assert compile_count("serve.engine.prefill") == 2
        assert len(eng._decode.__comq_graphs__) == 1
        assert eng._prefill.__comq_pool__ is eng._decode.__comq_pool__
        want_logits, cache = prefill(
            params, cfg, plan.replace(prefill_cache_len=PROMPT + NEW),
            torch.as_tensor(prompts, dtype=torch.int64),
            vision_embeds=None if ve is None else torch.as_tensor(ve))
        eager = [torch.argmax(want_logits, -1)]
        for i in range(NEW - 1):
            lg, cache = decode_step(params, cfg, plan.replace(
                prefill_cache_len=PROMPT + NEW), cache, eager[-1][:, None],
                PROMPT + i)
            eager.append(torch.argmax(lg, -1))
    assert torch.equal(seen[0], want_logits)
    assert torch.equal(seen[NEW], want_logits)
    np.testing.assert_array_equal(again, got)
    np.testing.assert_array_equal(got, torch.stack(eager, 1).numpy())
    if arch != VLM:
        jwant = JEngine(jp, jc, JPlan(remat=False, cache_dtype=jnp.float32),
                        max_len=PROMPT + NEW).generate_batch(
                            prompts, max_new_tokens=NEW)
        np.testing.assert_array_equal(got, np.asarray(jwant))


def test_lint_flags_a_clock_in_the_prefill_programs():
    """A clock put into the prefill or the write program (captured code:
    each is given to guard_graph) is a time-in-capture finding; the
    sources as they are are clean (test_torch_step_graph.py)."""
    src = inspect.getsource(runtime_mod)
    for fn in ("_prefill_forward", "_write_rows"):
        line = f"def {fn}("
        assert src.count(line) == 1
        at = src.index(line)
        body = src.index('"""\n', src.index('"""', at) + 3) + 4
        bad = src[:body] + "    t0 = time.time()\n" + src[body:]
        assert [f.rule for f in lint.lint_source(bad, "serve/runtime.py")] \
            == ["time-in-capture"]
