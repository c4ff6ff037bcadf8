"""The port's serving path (repro_torch.serve and launch.serve) on qwen2
smoke: greedy tokens identical to the JAX Runtime under mixed, staggered
and preempting traffic, and the in-port behaviour of tests/
test_serve_runtime.py and tests/test_serve.py — runtime == Engine, mixed
== solo, preempt/resume identity, priorities, reserve, stop tokens, seeded
sampling, sampler filters, allocator bookkeeping, packed == materialized,
the launcher."""
import json

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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import QuantSpec, materialize, quantize_model
from repro_torch.core.apply import is_qt, serving_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import BuildPlan, init_params
from repro_torch.serve import (BlockAllocator, Engine, Request, Runtime,
                               Scheduler, ServeConfig, paged_cache_bytes,
                               sample, sample_batch, sample_batch_seeded)

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SC = dict(max_slots=3, block_size=8, num_blocks=24, buckets=(8, 16, 32),
          max_blocks_per_slot=6)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg, JPlan(remat=False))
    return cfg, params


@pytest.fixture(scope="module")
def setup(jax_setup):
    """The port on the JAX init (converted through numpy), f32 compute."""
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    return cfg, params_from_numpy(jax.device_get(jax_setup[1]), "cpu")


def _plan(kv_bits=0):
    return BuildPlan(cache_dtype=torch.float32, kv_bits=kv_bits)


def _runtime(params, cfg, plan=None, **kw):
    return Runtime(params, cfg, plan or _plan(), ServeConfig(**{**SC, **kw}),
                   device="cpu")


def _prompts(seed, lens, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _staggered(rt, prompts, max_new=6):
    """Two up front, then one arrival per decode step; drained."""
    reqs = [rt.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for p in prompts[2:]:
        rt.step()
        reqs.append(rt.submit(p, max_new_tokens=max_new))
    rt.run()
    return [list(r.out_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# against the JAX Runtime (greedy tokens identical)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [0, 8])
def test_runtime_tokens_match_jax_mixed_staggered(jax_setup, setup,
                                                  kv_bits):
    jcfg, jparams = jax_setup
    cfg, params = setup
    prompts = _prompts(1, [5, 16, 11, 8])
    sc = {**SC, "max_slots": 2, "num_blocks": 12}
    jrt = JRuntime(jparams, jcfg, JPlan(remat=False, cache_dtype=jnp.float32,
                                        kv_bits=kv_bits), JServeConfig(**sc))
    want = _staggered(jrt, prompts)
    got = _staggered(_runtime(params, cfg, _plan(kv_bits), **sc), prompts)
    assert got == want


def test_runtime_tokens_match_jax_under_preemption(jax_setup, setup):
    """Mirrors tests/test_serve_runtime.py::test_preempt_resume_token_
    identity: 3 slots, 6 pages, so decode growth preempts and resumes."""
    jcfg, jparams = jax_setup
    cfg, params = setup
    prompts = _prompts(7, [14, 9, 12])
    sc = {**SC, "num_blocks": 6}
    jrt = JRuntime(jparams, jcfg, JPlan(remat=False, cache_dtype=jnp.float32),
                   JServeConfig(**sc))
    want = [np.asarray(t).tolist()
            for t in jrt.generate(prompts, max_new_tokens=8)]
    rt = _runtime(params, cfg, **sc)
    got = [t.tolist() for t in rt.generate(prompts, max_new_tokens=8)]
    assert jrt.scheduler.preemptions > 0
    assert rt.scheduler.preemptions == jrt.scheduler.preemptions
    assert got == want


# ---------------------------------------------------------------------------
# equivalence inside the port
# ---------------------------------------------------------------------------

def test_runtime_matches_engine_equal_length(setup):
    cfg, params = setup
    prompts = np.stack(_prompts(2, [16, 16]))
    want = Engine(params, cfg, _plan(), max_len=32,
                  device="cpu").generate_batch(prompts, max_new_tokens=8)
    rt = _runtime(params, cfg, max_slots=2, num_blocks=8, buckets=(16,),
                  max_blocks_per_slot=4)
    got = rt.generate([prompts[0], prompts[1]], max_new_tokens=8)
    np.testing.assert_array_equal(np.stack(got), want)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_mixed_staggered_matches_solo(setup, kv_bits):
    """Fewer slots than requests (slot + page reuse) and arrivals over
    time: every request's tokens equal its solo run through the same
    runtime, at every page width."""
    cfg, params = setup
    prompts = _prompts(1, [5, 16, 11, 8])
    rt = _runtime(params, cfg, _plan(kv_bits), max_slots=2, num_blocks=12)
    mixed = _staggered(rt, prompts)
    solo_rt = _runtime(params, cfg, _plan(kv_bits), max_slots=2,
                       num_blocks=12)
    for p, got in zip(prompts, mixed):
        assert got == solo_rt.generate([p], max_new_tokens=6)[0].tolist()
    rt.allocator.check_integrity()
    assert rt.allocator.num_free == rt.allocator.num_blocks
    assert rt.scheduler.idle


def test_preempt_resume_token_identity(setup):
    cfg, params = setup
    prompts = _prompts(7, [14, 9, 12])
    solo = [_runtime(params, cfg).generate([p], max_new_tokens=8)[0]
            for p in prompts]
    rt = _runtime(params, cfg, num_blocks=6)
    reqs = [rt.submit(p, max_new_tokens=8) for p in prompts]
    m = rt.run()
    assert m["preemptions"] > 0
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want.tolist()
    rt.allocator.check_integrity()
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_priority_latecomer_finishes_first(setup):
    cfg, params = setup
    prompts = _prompts(11, [10, 10, 10])
    solo = [_runtime(params, cfg).generate([p], max_new_tokens=6)[0]
            for p in prompts]
    rt = _runtime(params, cfg, max_slots=2, num_blocks=4)
    lo = [rt.submit(p, max_new_tokens=6, priority=5) for p in prompts[:2]]
    rt.step()
    hi = rt.submit(prompts[2], max_new_tokens=6, priority=0)
    rt.run()
    assert rt.scheduler.preemptions > 0
    done = [r.rid for r in rt.scheduler.completed]
    assert done.index(hi.rid) < max(done.index(r.rid) for r in lo)
    for r, want in zip(lo + [hi], solo):
        assert r.out_tokens == want.tolist()


def test_reserve_policy_never_preempts(setup):
    cfg, params = setup
    rt = _runtime(params, cfg, num_blocks=6, policy="reserve")
    reqs = [rt.submit(p, max_new_tokens=8)
            for p in _prompts(13, [10, 10, 10])]
    rt.run()
    assert rt.scheduler.preemptions == 0
    assert all(len(r.out_tokens) == 8 for r in reqs)
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_stop_token_terminates_early_and_frees_pages(setup):
    cfg, params = setup
    p = _prompts(3, [9])[0]
    ref = _runtime(params, cfg).generate([p], max_new_tokens=8)[0]
    rt = _runtime(params, cfg)
    req = rt.submit(p, max_new_tokens=8, stop_tokens=(int(ref[2]),))
    m = rt.run()
    assert req.finish_reason == "stop_token"
    assert req.out_tokens == ref[:ref.tolist().index(ref[2]) + 1].tolist()
    assert m["finish_reasons"] == ["stop_token"]
    assert rt.allocator.num_free == rt.allocator.num_blocks
    # the TTFT token itself can be the stop: retired at admission
    rt = _runtime(params, cfg)
    req = rt.submit(p, max_new_tokens=8, stop_tokens=(int(ref[0]),))
    m = rt.run()
    assert req.out_tokens == [int(ref[0])] and m["decode_steps"] == 0
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_stop_token_preserves_batchmates(setup):
    cfg, params = setup
    prompts = _prompts(5, [9, 12, 7])
    solo = [_runtime(params, cfg).generate([p], max_new_tokens=8)[0]
            for p in prompts]
    stop = int(solo[0][1])
    assert stop not in solo[1] and stop not in solo[2]
    rt = _runtime(params, cfg, max_slots=2, num_blocks=12)
    reqs = [rt.submit(prompts[0], max_new_tokens=8, stop_tokens=(stop,)),
            rt.submit(prompts[1], max_new_tokens=8),
            rt.submit(prompts[2], max_new_tokens=8)]
    rt.run()
    assert reqs[0].out_tokens == solo[0][:2].tolist()
    assert reqs[1].out_tokens == solo[1].tolist()
    assert reqs[2].out_tokens == solo[2].tolist()
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_seeded_sampling_identical_after_preemption(setup):
    """Temperature > 0: each draw is a pure function of (seed, token
    index), so a preempted + resumed stream matches its solo run."""
    cfg, params = setup
    prompts = _prompts(21, [9, 12, 14])
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=5)
    solo = [_runtime(params, cfg).generate([p], seed=100 + i, **kw)[0]
            for i, p in enumerate(prompts)]
    rt = _runtime(params, cfg, num_blocks=6)
    reqs = [rt.submit(p, seed=100 + i, **kw) for i, p in enumerate(prompts)]
    rt.run()
    assert rt.scheduler.preemptions > 0
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want.tolist()
    greedy = [_runtime(params, cfg).generate([p], max_new_tokens=8)[0]
              for p in prompts]
    assert any(not np.array_equal(a, b) for a, b in zip(solo, greedy))


def test_packed_serving_matches_materialized(setup):
    cfg, params = setup
    calib = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 40)))
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=2,
                     order="cyclic")
    qparams, _ = quantize_model(params, cfg, BuildPlan(), calib, spec,
                                method="comq_blocked")
    packed = serving_params(qparams, cfg)
    assert any(is_qt(v) for v in packed["layers"][0]["mlp"].values())
    prompts = _prompts(8, [12, 16])
    out_q = _runtime(packed, cfg).generate(prompts, max_new_tokens=8)
    out_m = _runtime(materialize(qparams, cfg), cfg).generate(
        prompts, max_new_tokens=8)
    for a, b in zip(out_q, out_m):
        np.testing.assert_array_equal(a, b)


def test_streaming_callback_and_metrics(setup):
    cfg, params = setup
    seen = []
    rt = _runtime(params, cfg)
    req = rt.submit(_prompts(4, [9])[0], max_new_tokens=5,
                    stream_cb=lambda r, t: seen.append(t))
    m = rt.run()
    assert seen == req.out_tokens and len(req.itl) == 4
    assert m["requests"] == 1 and m["new_tokens"] == 5
    assert m["itl_p50_s"] == float(np.percentile(req.itl, 50))
    assert m["itl_p99_s"] == float(np.percentile(req.itl, 99))
    assert 0 < m["cache_peak_occupancy"] <= 1.0
    snap = rt.metrics_snapshot()
    assert snap["retired"] == 1 and snap["running"] == 0


@pytest.mark.parametrize("kv_bits,dt,div", [(0, torch.float32, 1),
                                            (8, torch.int8, 1),
                                            (4, torch.uint8, 2)])
def test_runtime_pool_layout_and_bytes(setup, kv_bits, dt, div):
    cfg, params = setup
    rt = _runtime(params, cfg, _plan(kv_bits))
    hd = cfg.resolved_head_dim
    assert rt.pool["k"].dtype == dt
    assert tuple(rt.pool["k"].shape) == (cfg.n_layers, 24, 8,
                                         cfg.n_kv_heads, hd // div)
    if kv_bits:
        assert tuple(rt.pool["k_scale"].shape) == (cfg.n_layers, 24,
                                                   cfg.n_kv_heads)
    assert paged_cache_bytes(cfg, _plan(kv_bits), 24, 8) == sum(
        t.numel() * t.element_size() for t in rt.pool.values())


# ---------------------------------------------------------------------------
# scheduler + allocator (host-only)
# ---------------------------------------------------------------------------

def test_block_allocator_leak_double_free_and_partitions():
    a = BlockAllocator(8)
    x, y = a.alloc(3), a.alloc(5)
    assert x == [0, 1, 2] and a.num_free == 0 and a.alloc(1) is None
    a.free(y)
    assert a.num_free == 5 and a.peak_in_use == 8
    with pytest.raises(ValueError):
        a.free(y[:1])                # double free
    with pytest.raises(ValueError):
        a.free([99])                 # unknown block
    a.free(x)
    a.check_integrity()
    p = BlockAllocator(12, partitions=3)
    got = {i: p.alloc(4, part=i) for i in range(3)}
    for i, pages in got.items():
        assert set(pages) == set(range(i * 4, (i + 1) * 4))
    assert p.alloc(1, part=1) is None
    p._held.discard(5)               # a leaked page is caught
    with pytest.raises(AssertionError, match="leaked"):
        p.check_integrity()
    with pytest.raises(ValueError):
        BlockAllocator(10, partitions=3)


def test_scheduler_buckets_priorities_and_preemption():
    a = BlockAllocator(6)
    s = Scheduler(max_slots=2, allocator=a, buckets=(8, 16), block_size=4,
                  max_blocks_per_slot=4)
    assert s.bucket_for(3) == 8 and s.bucket_for(9) == 16
    assert s.bucket_for(40, extend=True) == 64
    with pytest.raises(ValueError):
        s.bucket_for(17)
    r1 = s.submit(Request(prompt=np.arange(8), max_new_tokens=5))
    r2 = s.submit(Request(prompt=np.arange(8), max_new_tokens=5))
    r3 = s.submit(Request(prompt=np.arange(4), max_new_tokens=2))
    assert s.admit() == [r1, r2]
    s.release(r1)
    assert s.admit() == [r3]
    s.release(r2)
    s.release(r3)
    assert a.num_free == 6 and s.idle
    # (priority, rid) order; an urgent head preempts, an equal one waits
    a = BlockAllocator(4)
    s = Scheduler(max_slots=1, allocator=a, buckets=(8,), block_size=4,
                  max_blocks_per_slot=4)
    lo = s.submit(Request(prompt=np.arange(8), max_new_tokens=5,
                          priority=5))
    assert s.admit() == [lo]
    lo.out_tokens = [1, 2]
    hi = s.submit(Request(prompt=np.arange(8), max_new_tokens=5,
                          priority=0))
    cleared = []
    assert s.admit(on_preempt=cleared.append) == [hi] and cleared == [lo]
    assert lo.state == "queued" and lo.n_preempts == 1
    eq = s.submit(Request(prompt=np.arange(8), max_new_tokens=5,
                          priority=0))
    assert s.admit() == [] and eq.state == "queued"
    s.release(hi)
    assert s.admit() == [eq]         # priority 0 before the preempted lo
    s.release(eq)
    assert s.admit() == [lo]         # lo kept its rid
    s.release(lo)
    a.check_integrity()


def test_allocator_fault_hook_keeps_integrity(setup):
    """Page-alloc failures at admission and growth (the allocator's
    fail_hook): no leak, no double free, no lost request."""
    cfg, params = setup
    prompts = _prompts(17, [12, 9, 14])
    solo = [_runtime(params, cfg).generate([p], max_new_tokens=6)[0]
            for p in prompts]
    calls = {"n": 0}

    def hook():
        calls["n"] += 1
        return calls["n"] in (2, 4, 7)

    rt = _runtime(params, cfg)
    rt.allocator.fail_hook = hook
    reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
    rt.run()
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want.tolist()
    rt.allocator.check_integrity()
    assert rt.allocator.num_free == rt.allocator.num_blocks
    assert sorted(r.rid for r in rt.scheduler.completed) == [0, 1, 2]


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_sampler_modes_and_filters():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert int(sample(logits, g, temperature=0.0)[0]) == 1
    s = sample(logits.repeat(64, 1), g, temperature=1.0, top_k=2)
    assert set(s.tolist()) <= {1, 2}
    s = sample(logits.repeat(512, 1), g, temperature=1.0, top_p=0.5)
    assert set(s.tolist()) == {1}
    flat = torch.tensor([[2.0, 2.1, 1.9, -5.0]]).repeat(512, 1)
    assert set(sample(flat, g, temperature=1.0, top_p=0.6).tolist()) \
        == {0, 1}
    four = torch.tensor([[0.0, 5.0, 1.0, 4.0]]).repeat(256, 1)
    ones = torch.ones(256)
    s_k = sample_batch(four, g, temperature=ones,
                       top_k=torch.full((256,), 2), top_p=torch.zeros(256))
    assert set(s_k.tolist()) <= {1, 3}
    s_p = sample_batch(four, g, temperature=ones,
                       top_k=torch.zeros(256, dtype=torch.int64),
                       top_p=torch.full((256,), 0.05))
    assert set(s_p.tolist()) == {1}


def test_seeded_sampler_rows_are_pure_functions_of_seed_and_count():
    logits = torch.randn(8, 32, generator=torch.Generator().manual_seed(3))
    temp = np.asarray([0.0, 1.0, 0.7, 1.3, 0.0, 1.0, 1.0, 0.5], np.float32)
    top_k = np.asarray([0, 5, 0, 3, 0, 0, 8, 0], np.int32)
    top_p = np.asarray([0.0, 0.0, 0.9, 0.5, 0.0, 0.3, 0.0, 0.95],
                       np.float32)
    seeds = np.arange(8, dtype=np.uint32) + 40
    counts = np.arange(8, dtype=np.int32)
    kw = dict(temperature=temp, top_k=top_k, top_p=top_p)
    a = sample_batch_seeded(logits, seeds, counts, **kw)
    assert a.dtype == torch.int32
    assert torch.equal(a, sample_batch_seeded(logits, seeds, counts, **kw))
    # row 3 alone, moved to another slot, with other batchmates
    perm = [3, 0, 1, 2, 4, 5, 6, 7]
    b = sample_batch_seeded(logits[perm], seeds[perm], counts[perm],
                            temperature=temp[perm], top_k=top_k[perm],
                            top_p=top_p[perm])
    assert int(b[0]) == int(a[3])
    greedy = torch.argmax(logits, -1)
    assert int(a[0]) == int(greedy[0]) and int(a[4]) == int(greedy[4])
    draws = {int(sample_batch_seeded(logits[1:2], [seeds[1]], [c],
                                     temperature=[5.0], top_k=[0],
                                     top_p=[0.0])[0]) for c in range(40)}
    assert len(draws) > 1            # the count moves the draw


# ---------------------------------------------------------------------------
# launcher and device defaults
# ---------------------------------------------------------------------------

def test_launcher_cpu_json_line(tmp_path, capsys):
    path = str(tmp_path / "q.qpk")
    out = launch_serve.main(["--arch", "qwen2-7b", "--smoke", "--quantize",
                             "--save-quantized", path, "--num-requests", "3",
                             "--max-new", "4", "--mixed", "--stagger", "2",
                             "--kv-bits", "8", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["finish_reasons"] == ["length"] * 3
    assert line["packed_qt"] and line["kv_bits"] == 8
    assert line["new_tokens"] == out["new_tokens"] >= 8
    # the saved packed tree serves the same tokens, and the JAX package
    # reads the file
    again = launch_serve.main(["--arch", "qwen2-7b", "--smoke",
                               "--load-quantized", path, "--num-requests",
                               "3", "--max-new", "4", "--mixed", "--stagger",
                               "2", "--kv-bits", "8", "--device", "cpu"])
    assert again["sample"] == out["sample"]
    from repro.ckpt import load_packed_ckpt as jload
    assert jload(path)["arch"] == "qwen2-7b-smoke"
    static = launch_serve.main(["--arch", "qwen2-7b", "--smoke", "--engine",
                                "static", "--num-requests", "2", "--max-new",
                                "3", "--device", "cpu"])
    assert static["new_tokens"] == 6


# the JAX serve launcher's flags that the port once refused: every one is
# ported now, and each runs and leaves its output
@pytest.mark.parametrize("flag", ["--inject", "--journal", "--metrics",
                                  "--restarts", "--resume", "--trace"])
def test_launcher_rejects_unported_flags(flag, tmp_path):
    from repro_torch.obs import reconstruct_timelines, validate_trace_file
    extra = {"--inject": ["--inject", "decode_step:99"],
             "--journal": ["--journal", str(tmp_path)],
             "--metrics": ["--metrics", str(tmp_path)],
             "--restarts": ["--journal", str(tmp_path), "--restarts", "1"],
             "--resume": ["--journal", str(tmp_path), "--resume"],
             "--trace": ["--trace", str(tmp_path)]}[flag]
    out = launch_serve.main(["--arch", "qwen2-7b", "--smoke", "--device",
                             "cpu", "--num-requests", "2", "--prompt-len",
                             "8", "--max-new", "2"] + extra)
    # --resume over an empty journal has nothing in flight to replay
    assert out["requests"] == (0 if flag == "--resume" else 2)
    if flag == "--trace":
        path = tmp_path / "serve.g0.trace.json"
        assert validate_trace_file(str(path)) == []
        tls = reconstruct_timelines(json.loads(path.read_text())
                                    ["traceEvents"])
        assert sorted(tls) == [0, 1]
        assert all(len(tl.tokens) == 2 and tl.complete
                   for tl in tls.values())
    if flag == "--metrics":
        recs = {r["name"]: r for r in map(
            json.loads, (tmp_path / "metrics.jsonl").read_text().splitlines())}
        assert recs["serve.tokens_emitted"]["value"] == out["new_tokens"]
        assert recs["serve.requests_retired"]["value"] == 2
        assert "serve_tokens_emitted 4.0" in (
            tmp_path / "metrics.prom").read_text()


# Runtime's arguments that the port once refused: a journal, an injector,
# a tracer, a registry and a mesh are taken and used (the mesh as a gloo
# world of one in this process; a model axis that does not divide
# num_blocks raises the JAX runtime's error)
@pytest.mark.parametrize("arg", ["journal", "injector", "tracer", "metrics",
                                 "mesh"])
def test_runtime_rejects_unported_arguments(setup, jax_setup, arg, tmp_path):
    from repro_torch.ft import FaultInjector, Journal
    from repro_torch.obs import MetricsRegistry, Tracer
    cfg, params = setup
    if arg == "mesh":
        from types import SimpleNamespace

        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import dist as rd
        dev, started = rd.init_world("gloo", "cpu")
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
            rt = Runtime(params, cfg, _plan(), ServeConfig(**SC),
                         device="cpu", mesh=mesh)
            prompts = _prompts(1, [5, 9])
            want = _runtime(params, cfg).generate(prompts, max_new_tokens=3)
            got = rt.generate(prompts, max_new_tokens=3)
            assert [g.tolist() for g in got] == [w.tolist() for w in want]
        finally:
            rd.close_world(started)
        odd = {**SC, "num_blocks": 25}
        stub = SimpleNamespace(shape={"model": 2})
        with pytest.raises(ValueError) as ej:
            JRuntime(jax_setup[1], jax_setup[0], JPlan(remat=False),
                     JServeConfig(**odd), mesh=stub)
        with pytest.raises(ValueError) as et:
            Runtime(params, cfg, _plan(), ServeConfig(**odd), device="cpu",
                    mesh=stub)
        assert str(et.value) == str(ej.value)
        return
    value = {"journal": lambda: Journal(str(tmp_path)),
             "injector": FaultInjector, "tracer": Tracer,
             "metrics": MetricsRegistry}[arg]()
    rt = Runtime(params, cfg, _plan(), ServeConfig(**SC), device="cpu",
                 **{arg: value})
    assert getattr(rt, arg) is value
    assert len(rt.generate(_prompts(1, [5]), max_new_tokens=2)[0]) == 2
    if arg == "tracer":
        names = [e["name"] for e in value.events]
        assert names.count("token") == 2 and "decode_step" in names
    if arg == "metrics":
        assert value.snapshot()["serve.tokens_emitted"] == 2.0


def test_cuda_default_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg, params = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        Runtime(params, cfg, _plan(), ServeConfig(**SC))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg, _plan())
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "qwen2-7b", "--smoke"])


def test_count_params_matches_init():
    cfg = get_smoke_config(ARCH)
    p = init_params(cfg, seed=0, device="cpu")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert launch_serve.count_params(cfg) == n
