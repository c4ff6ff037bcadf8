"""The serving steps as one compiled program per signature: the port's
`analysis.retrace.guard_graph` (JAX's `guard_jit`), the paged Runtime's
decode step and the static Engine's, on the CPU.

On the CPU a guard_graph runs its step eagerly through the same static
buffers the card's graph reads, and refuses at a signature's first call
the ops a capture refuses. These tests hold the Engine's device-scalar
position to the int position bit for bit (dense, hybrid, rwkv and VLM
smoke configs cut to 2 layers, the VLM to its one group of 5, f32) and
the dense one's tokens to JAX's Engine, one signature across every
position, the Runtime's static buffers across steps and its tokens
against JAX's Runtime on mixed, staggered traffic over 4-bit pages, the
budget, the refusals and the lint over the capture sites. Every Engine
and Runtime runs its step through the guard, so the families' own files
hold the captured step to JAX's too: the Engine's tokens from packed
codes in test_torch_ssm.py, test_torch_rwkv.py and test_torch_vlm.py,
the Runtime's at kv_bits 0 and 8 in test_torch_serve.py. The card's side
(replay against eager logits, launches a replay, a refused capture) is in
test_torch_cuda.py.
"""
import ast
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
from repro_torch.analysis import lint, retrace
from repro_torch.analysis.retrace import (GraphCaptureError,
                                          RetraceViolation, compile_count,
                                          guard_graph)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import (BuildPlan, decode_step, init_params,
                                 prefill)
from repro_torch.serve import Engine, Runtime, ServeConfig
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import runtime as runtime_mod

torch.set_num_threads(2)

VLM = "llama-3.2-vision-90b"
# arch -> depth: 2 layers, the VLM one group (4 self + 1 cross layer)
ENGINE_ARCHS = {"qwen2-7b": 2, "hymba-1.5b": 2, "rwkv6-7b": 2, VLM: 5}
PROMPT, NEW = 12, 6     # the hymba smoke's window is 8: the ring wraps


def _params(arch, cfg):
    """The port's init; the VLM's cross gates at 0.5, so that a cross
    layer adds to x (zero at init, as in JAX)."""
    p = init_params(cfg, seed=0, device="cpu")
    if arch == VLM:
        for cross in p["groups"]["cross"]:
            for name in ("gate_attn", "gate_mlp"):
                cross[name] = torch.full_like(cross[name], 0.5)
    return p


def _inputs(arch, vocab):
    rs = np.random.RandomState(3)
    prompts = rs.randint(0, vocab, (3, PROMPT)).astype(np.int32)
    ve = None
    if arch == VLM:
        ca = jax_cfg(VLM).cross_attn
        ve = rs.standard_normal((3, ca.n_vision_tokens,
                                 ca.vision_dim)).astype(np.float32)
    return prompts, ve


def _int_pos_logits(params, cfg, plan, prompts, ve):
    """The decode loop with a Python-int position (the eager path the
    captured step replaces), greedy: each step's logits."""
    tokens = torch.as_tensor(prompts, dtype=torch.int64)
    logits, cache = prefill(params, cfg, plan, tokens,
                            vision_embeds=None if ve is None
                            else torch.as_tensor(ve))
    out = []
    for i in range(NEW - 1):
        nxt = torch.argmax(logits, dim=-1)
        logits, cache = decode_step(params, cfg, plan, cache, nxt[:, None],
                                    PROMPT + i)
        out.append(logits.clone())
    return out


@pytest.mark.parametrize("arch", list(ENGINE_ARCHS))
def test_engine_device_pos_matches_int_pos_and_jax(arch, monkeypatch,
                                                    request):
    """The Engine's captured step (a device-scalar position the step
    advances, the states copied back into its static cache) gives the
    int-position loop's logits bit for bit, under one signature for every
    position and for a second batch of the same shapes; the dense model's
    greedy tokens are JAX's Engine's (the other families': their files)."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         n_layers=ENGINE_ARCHS[arch])
    if arch == "qwen2-7b":
        jc, jp, _, params = request.getfixturevalue("qwen")
    else:
        params = _params(arch, cfg)
    prompts, ve = _inputs(arch, cfg.vocab_size)
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
        ref = _int_pos_logits(params, cfg, plan.replace(
            prefill_cache_len=PROMPT + NEW), prompts, ve)
    if arch == "qwen2-7b":
        want = JEngine(jp, jc, JPlan(remat=False, cache_dtype=jnp.float32),
                       max_len=PROMPT + NEW).generate_batch(
                           prompts, max_new_tokens=NEW)
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(again, got)
    np.testing.assert_array_equal(got[:, 1:], np.stack(
        [torch.argmax(r, dim=-1).numpy() for r in ref], 1))
    assert compile_count("serve.engine.decode_step") == 1
    assert len(eng._decode.__comq_graphs__) == 1
    for i, r in enumerate(ref):           # seen[0] is the prefill's
        assert torch.equal(seen[i + 1], r), f"step {i}"


def test_guard_graph_budget_and_held_arguments():
    """A second signature raises under pytest: another input shape, or
    another object where the graph holds one (a rebound pool)."""
    retrace.reset_guards("t.graph")
    state = torch.zeros(4)

    def step(state, x):
        state += x
        return state * 2.0

    g = guard_graph(step, name="t.graph", max_signatures=1,
                    copy_argnums=(1,), device="cpu")
    x = torch.ones(4)
    for _ in range(3):
        out = g(state, x)
    assert torch.equal(state, torch.full((4,), 3.0))
    assert torch.equal(out, torch.full((4,), 6.0))
    assert compile_count("t.graph") == 1
    with pytest.raises(RetraceViolation, match="budget of 1"):
        g(state, torch.ones(5))
    with pytest.raises(RetraceViolation, match="budget of 1"):
        g(torch.zeros(4), x)


@pytest.mark.parametrize("body", ["item", "nonzero", "mask"])
def test_guard_graph_refuses_a_host_read_and_does_not_fall_back(body):
    """A step that makes the host wait for the card raises at its
    signature's first call, naming the op, and raises again at the
    next call: nothing runs it in place of a graph."""
    def step(x):
        if body == "item":
            return x * float(x.sum())
        if body == "nonzero":
            return torch.nonzero(x)
        return x[x > 0]

    op = {"item": "_local_scalar_dense", "nonzero": "nonzero",
          "mask": "index"}[body]
    g = guard_graph(step, name=f"t.refuse.{body}", copy_argnums=(0,),
                    per_signature=True, device="cpu")
    for _ in range(2):
        with pytest.raises(GraphCaptureError, match=f"aten::{op}"):
            g(torch.ones(3))
    assert g.__comq_graphs__ == {}


def _runtime(params, cfg, kv_bits=0, **kw):
    sc = dict(max_slots=2, block_size=8, num_blocks=12, buckets=(8, 16),
              max_blocks_per_slot=4)
    return Runtime(params, cfg, BuildPlan(cache_dtype=torch.float32,
                                          kv_bits=kv_bits),
                   ServeConfig(**{**sc, **kw}), device="cpu")


def _staggered(rt, prompts, after_step=None):
    reqs = [rt.submit(p, max_new_tokens=6) for p in prompts[:2]]
    for p in prompts[2:]:
        rt.step()
        if after_step is not None:
            after_step(rt)
        reqs.append(rt.submit(p, max_new_tokens=6))
    while not rt.scheduler.idle:
        rt.step()
        if after_step is not None:
            after_step(rt)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def qwen():
    jc = jax_cfg("qwen2-7b").replace(compute_dtype="float32", n_layers=2)
    jp = jax_init(jax.random.PRNGKey(0), jc, JPlan(remat=False))
    cfg = get_smoke_config("qwen2-7b").replace(compute_dtype="float32",
                                               n_layers=2)
    return jc, jp, cfg, params_from_numpy(jax.device_get(jp), "cpu")


def test_runtime_static_buffers_keep_their_identity(qwen):
    """Across a mixed, staggered run the step reads the same buffers:
    one signature, the pinned-host and device inputs, the block tables
    and the pool never rebound."""
    _, _, cfg, params = qwen
    rt = _runtime(params, cfg)
    ids = []

    def note(rt):
        (cap,) = rt._decode.__comq_graphs__.values()
        ids.append(tuple(t.data_ptr() for t in (
            rt._h_tok, rt._h_pos, rt._h_bt, rt._bt_dev, rt.pool["k"],
            rt.pool["v"], cap.args[5], cap.args[6])) + (
            id(rt.pool), id(cap.args[3]), id(cap.args[4])))

    pool = rt.pool
    _staggered(rt, [np.arange(n, dtype=np.int32) % 200 for n in
                    (5, 14, 9, 3)], after_step=note)
    assert len(ids) > 8 and len(set(ids)) == 1
    assert rt.pool is pool and compile_count("serve.decode_step") == 1
    assert rt.graph_pool_bytes() == 0         # no graph on the CPU


def test_runtime_tokens_match_jax_mixed_staggered_kv4(qwen):
    """The captured step's tokens are JAX's on mixed, staggered traffic
    over 4-bit pages (kv_bits 0 and 8: tests/test_torch_serve.py)."""
    jc, jp, cfg, params = qwen
    prompts = [np.random.RandomState(1).randint(0, 256, (n,)).astype(
        np.int32) for n in (5, 16, 11, 8)]
    sc = dict(max_slots=2, block_size=8, num_blocks=12, buckets=(8, 16),
              max_blocks_per_slot=4)
    want = _staggered(JRuntime(jp, jc, JPlan(remat=False,
                                             cache_dtype=jnp.float32,
                                             kv_bits=4),
                               JServeConfig(**sc)), prompts)
    assert _staggered(_runtime(params, cfg, kv_bits=4), prompts) == want


def test_launch_state_round_trip():
    """What a capture takes back and a replay adds: a difference of two
    launch states, every counter included."""
    from repro_torch.kernels import paged_attention, quant_matmul
    ops.reset_launch_counts()
    before = ops.launch_state()
    quant_matmul.launches += 3
    quant_matmul.launches_by_cpb[2] += 3
    paged_attention.launches_quant_tc += 1
    after = ops.launch_state()
    delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
    assert delta == {("repro_torch.kernels.quant_matmul", "launches"): 3,
                     ("cpb", 2): 3, ("repro_torch.kernels.paged_attention",
                                     "launches_quant_tc"): 1}
    ops.add_launches(delta)
    assert ops.launch_counts()["quant_matmul"] == 6
    ops.add_launches({k: -n for k, n in ops.launch_state().items()})
    assert all(v == 0 for v in ops.launch_state().values())


def test_lint_is_clean_over_the_capture_sites():
    """The capture site is one the time-in-capture rule reads (a clock
    put inside it is flagged), the replay is a host-sync hot zone, the
    programs the Engine and the Runtime give guard_graph (decode steps,
    prefills, the prefill write) are captured code to that rule, and the
    sources are clean."""
    src = inspect.getsource(retrace)
    assert lint.lint_source(src, "analysis/retrace.py") == []
    line = "                static_out = fn(*static)\n"
    assert src.count(line) == 1
    bad = src.replace(line, line.replace("fn(*static)",
                                         "fn(*static) * time.time()"))
    finds = lint.lint_source(bad, "analysis/retrace.py")
    assert [f.rule for f in finds] == ["time-in-capture"]
    zones = lint.HOT_ZONES["analysis/retrace.py"]
    assert "guard_graph.guarded" in zones
    assert set(zones) <= lint.qualnames(ast.parse(src))
    for mod, rel, captured in (
            (engine_mod, "serve/engine.py", {"_prefill_batch",
                                             "_decode_into"}),
            (runtime_mod, "serve/runtime.py", {"_decode_step",
                                               "_prefill_forward",
                                               "_write_rows"})):
        src = inspect.getsource(mod)
        assert lint.lint_source(src, rel) == []
        assert captured <= {b.name for b in lint._captured_bodies(
            ast.parse(src)) if isinstance(b, ast.FunctionDef)}
