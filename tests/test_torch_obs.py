"""The port's observability layer (repro_torch.obs) on its own: tracer spans
and the Chrome-trace schema, the record_function device bridge, the null
singletons, histogram quantiles against np.percentile, the sinks, request
timelines (crash-replay dedup, inconsistencies), the CLIs, and the
instrumented runtime and walk on qwen2 smoke — tokens and packed bytes
equal to uninstrumented runs (the mirror of tests/test_obs.py)."""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.ckpt import pack_tree, save_packed_ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.ft import FaultInjector, Heartbeat, SimulatedKill
from repro_torch.launch import serve as launch_serve
from repro_torch.models import BuildPlan, init_params
from repro_torch.obs import (NULL_METRICS, NULL_TRACER, MetricsRegistry,
                             Tracer, dedup_events, next_trace_path,
                             reconstruct_timelines, validate_timeline,
                             validate_trace, validate_trace_file)
from repro_torch.obs import report as obs_report
from repro_torch.obs import validate as obs_validate
from repro_torch.serve import Runtime, ServeConfig

torch.set_num_threads(2)

ARCH = "qwen2-7b"


@pytest.fixture(scope="module")
def f32_setup():
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    return cfg, BuildPlan(cache_dtype=torch.float32), init_params(
        cfg, seed=0, device="cpu")


# ---------------------------------------------------------------------------
# tracer: span nesting, Chrome-trace schema, the device bridge
# ---------------------------------------------------------------------------

def test_span_nesting_and_chrome_trace_schema(tmp_path):
    tr = Tracer(run="unit")
    with tr.span("outer", layer=3) as outer:
        assert outer.elapsed_s >= 0.0
        with tr.span("inner", leaf="wq", device=True):
            pass
        tr.instant("note", k=1)
    tr.request_event("submit", 7, prompt_len=5)
    tr.token_event(7, 0, 42, 1234.5)

    by_name = {e["name"]: e for e in tr.events}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["ph"] == outer["ph"] == "X" and inner["cat"] == "span"
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
    assert outer["args"] == {"layer": 3}
    assert by_name["note"]["cat"] == "instant"
    assert by_name["submit"]["cat"] == "request"
    assert by_name["submit"]["args"]["rid"] == 7
    tok = by_name["token"]
    assert tok["cat"] == "request" and tok["ts"] == 1234.5
    assert tok["args"] == {"rid": 7, "i": 0, "token": 42}

    assert validate_trace(tr.to_chrome_trace()) == []
    path = next_trace_path(str(tmp_path), "unit")
    assert path.endswith("unit.g0.trace.json")
    tr.save(path)
    assert validate_trace_file(path) == []
    assert next_trace_path(str(tmp_path), "unit").endswith(
        "unit.g1.trace.json")


def test_device_span_is_a_profiler_annotation():
    """A device=True span enters torch.profiler.record_function: under a
    profiler its name is a user annotation enclosing the ops inside it; a
    host-only span is not."""
    tr = Tracer(run="unit")
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("decode_step", device=True, step=0):
            torch.mm(x, x)
        with tr.span("host_only"):
            torch.mm(x, x)
    evs = {e.name: e for e in prof.events()}
    assert "decode_step" in evs and "host_only" not in evs
    ann = evs["decode_step"]
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    inside = [e for e in mms if ann.time_range.start <= e.time_range.start
              and e.time_range.end <= ann.time_range.end]
    assert len(mms) == 2 and len(inside) == 1
    assert [e["name"] for e in tr.events] == ["decode_step", "host_only"]


def test_validate_trace_rejects_malformed():
    assert validate_trace([]) != []
    assert validate_trace({"traceEvents": [{"name": "x"}]}) != []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                            "pid": 1, "tid": 1, "dur": -1.0}]}
    assert any("dur" in p for p in validate_trace(bad))
    bad_i = {"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0,
                              "pid": 1, "tid": 1, "s": "q"}]}
    assert any("scope" in p for p in validate_trace(bad_i))


def test_null_singletons_are_inert():
    assert NULL_TRACER.enabled is False and NULL_METRICS.enabled is False
    with NULL_TRACER.span("x", device=True) as s:
        assert s is NULL_TRACER.span("y")
    assert NULL_TRACER.request_event("submit", 0) is None
    assert NULL_TRACER.token_event(0, 0, 0, 0.0) is None
    c = NULL_METRICS.counter("a")
    assert c is NULL_METRICS.histogram("b")
    c.inc()
    c.observe(3.0)
    assert c.value == 0.0 and c.count == 0
    assert NULL_METRICS.snapshot() == {}


# ---------------------------------------------------------------------------
# metrics: quantiles + sinks
# ---------------------------------------------------------------------------

def test_histogram_quantile_matches_numpy():
    rs = np.random.RandomState(3)
    vals = rs.randn(101).tolist()
    reg = MetricsRegistry(run="unit")
    h = reg.histogram("itl")
    for v in vals:
        h.observe(v)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == float(np.percentile(vals, q * 100.0))
    one = reg.histogram("one")
    one.observe(2.5)
    assert one.quantile(0.99) == 2.5
    assert np.isnan(reg.histogram("empty").quantile(0.5))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(-1e6, 1e6, allow_nan=False), min_size=1,
                max_size=64),
       st.floats(0.0, 1.0))
def test_histogram_quantile_is_numpy_bit_for_bit(vals, q):
    reg = MetricsRegistry(run="hyp")
    h = reg.histogram("h")
    for v in vals:
        h.observe(v)
    assert h.quantile(q) == float(np.percentile(vals, q * 100.0))


def test_metrics_sinks_roundtrip(tmp_path):
    reg = MetricsRegistry(run="unit")
    reg.counter("serve.tokens").inc(5)
    reg.gauge("pool.free").set(8.0)
    h = reg.histogram("serve.itl_seconds")
    for v in (0.001, 0.002, 0.4):
        h.observe(v)

    jpath = str(tmp_path / "metrics.jsonl")
    reg.dump_jsonl(jpath)
    recs = {r["name"]: r for r in
            (json.loads(ln) for ln in open(jpath) if ln.strip())}
    assert recs["serve.tokens"] == {"name": "serve.tokens",
                                    "kind": "counter", "run": "unit",
                                    "value": 5.0}
    assert recs["pool.free"]["value"] == 8.0
    assert recs["serve.itl_seconds"]["values"] == [0.001, 0.002, 0.4]
    assert recs["serve.itl_seconds"]["count"] == 3

    ppath = str(tmp_path / "metrics.prom")
    reg.dump_prometheus(ppath)
    prom = open(ppath).read()
    assert "# TYPE serve_tokens counter" in prom
    assert "serve_tokens 5.0" in prom
    assert "# TYPE serve_itl_seconds histogram" in prom
    assert 'serve_itl_seconds_bucket{le="0.0025"} 2' in prom
    assert 'serve_itl_seconds_bucket{le="+Inf"} 3' in prom
    assert "serve_itl_seconds_count 3" in prom

    snap = reg.snapshot()
    assert snap["serve.tokens"] == 5.0
    assert snap["serve.itl_seconds"]["count"] == 3
    assert snap["serve.itl_seconds"]["p50"] == 0.002


# ---------------------------------------------------------------------------
# timelines: crash-replay dedup (synthetic event streams)
# ---------------------------------------------------------------------------

def _rev(name, ts, **args):
    return {"name": name, "ph": "i", "cat": "request", "s": "t",
            "ts": float(ts), "pid": 1, "tid": 1, "args": args}


def test_timeline_crash_replay_rid_dedup():
    """Two restart generations of one request: keep-first by rid for
    submit / first_token / retire, by (rid, i) for tokens, exact
    duplicates of the rest collapse, new events land."""
    gen0 = [
        _rev("submit", 1, rid=0, prompt_len=4, max_new_tokens=3, priority=0),
        _rev("admit", 2, rid=0, slot=0, resumed=False, prefill_len=4),
        _rev("first_token", 3, rid=0, token=7),
        _rev("token", 3, rid=0, i=0, token=7),
        _rev("token", 4, rid=0, i=1, token=8),
        _rev("preempt", 5, rid=0, n_preempts=1),
        _rev("admit", 2, rid=0, slot=0, resumed=False, prefill_len=4),
    ]
    gen1 = [
        _rev("submit", 11, rid=0, prompt_len=4, max_new_tokens=3, priority=0),
        _rev("admit", 12, rid=0, slot=1, resumed=True, prefill_len=8),
        _rev("first_token", 12, rid=0, token=7),
        _rev("token", 12, rid=0, i=0, token=7),
        _rev("token", 13, rid=0, i=1, token=8),
        _rev("token", 14, rid=0, i=2, token=9),
        _rev("retire", 15, rid=0, reason="length", new_tokens=3),
    ]
    merged = gen0 + gen1
    deduped = dedup_events(merged)
    assert sum(e["name"] == "token" for e in deduped) == 3
    assert sum(e["name"] == "submit" for e in deduped) == 1
    assert sum(e["name"] == "admit" for e in deduped) == 2

    tl = reconstruct_timelines(merged)[0]
    assert tl.t_submit == 1.0 and tl.t_first_token == 3.0
    assert tl.t_retire == 15.0 and tl.new_tokens == 3
    assert tl.tokens == [(0, 7), (1, 8), (2, 9)]
    assert tl.preempts == [5.0] and tl.resumes == [12.0]
    assert len(tl.admits) == 2
    assert tl.complete and validate_timeline(tl) == []
    assert tl.ttft_s == pytest.approx(2.0 / 1e6)
    assert tl.wall_s == pytest.approx(14.0 / 1e6)


@pytest.mark.parametrize("case,want", [
    ("count", "token events"), ("admit", "never admitted"),
    ("order", "out of order"), ("gap", "not contiguous"),
    ("preempts", "preempts but only")])
def test_timeline_validation_flags_inconsistencies(case, want):
    base = [_rev("submit", 1, rid=4, prompt_len=2),
            _rev("admit", 2, rid=4, slot=0, resumed=False, prefill_len=2),
            _rev("first_token", 3, rid=4, token=1),
            _rev("token", 3, rid=4, i=0, token=1)]
    evs = {
        "count": base + [_rev("retire", 9, rid=4, reason="length",
                              new_tokens=2)],
        "admit": base[:1],
        "order": base + [_rev("retire", 2.5, rid=4, reason="length",
                              new_tokens=1)],
        "gap": base + [_rev("token", 4, rid=4, i=2, token=5),
                       _rev("retire", 9, rid=4, reason="length",
                            new_tokens=2)],
        "preempts": base + [_rev("preempt", 4, rid=4, n_preempts=1),
                            _rev("preempt", 5, rid=4, n_preempts=2),
                            _rev("preempt", 6, rid=4, n_preempts=3)],
    }[case]
    probs = validate_timeline(reconstruct_timelines(evs)[4])
    assert any(want in p for p in probs), probs


# ---------------------------------------------------------------------------
# the instrumented runtime and walk (port only; JAX in test_torch_obs_parity)
# ---------------------------------------------------------------------------

def test_serve_obs_end_to_end_preempt_resume(f32_setup):
    """An over-subscribed instrumented run emits the uninstrumented
    runtime's tokens, rebuilds a clean timeline for every request (one at
    least preempted and resumed) whose tokens are the delivered stream,
    and lands registry counts equal to the runtime's own."""
    cfg, plan, params = f32_setup
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (14, 9, 12)]
    sc = ServeConfig(max_slots=3, block_size=8, num_blocks=6,
                     buckets=(8, 16, 32), max_blocks_per_slot=6)
    rt_plain = Runtime(params, cfg, plan, sc, device="cpu")
    assert rt_plain.tracer is NULL_TRACER and rt_plain.metrics is NULL_METRICS
    plain = rt_plain.generate(prompts, max_new_tokens=8)

    tr, reg = Tracer(run="test"), MetricsRegistry(run="test")
    rt = Runtime(params, cfg, plan, sc, tracer=tr, metrics=reg, device="cpu")
    reqs = [rt.submit(p, max_new_tokens=8) for p in prompts]
    out = rt.run()
    assert rt.scheduler.preemptions > 0
    for r, want in zip(reqs, plain):
        assert list(r.out_tokens) == want.tolist()

    assert validate_trace(tr.to_chrome_trace()) == []
    tls = reconstruct_timelines(tr.events)
    assert set(tls) == {r.rid for r in reqs}
    for r in reqs:
        tl = tls[r.rid]
        assert tl.complete and validate_timeline(tl) == []
        assert [t for _, t in tl.tokens] == [int(t) for t in r.out_tokens]
        assert tl.prompt_len == len(r.prompt)
        assert tl.finish_reason == r.finish_reason
    assert any(tls[r.rid].preempts and tls[r.rid].resumes for r in reqs)
    spans = [e for e in tr.events if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"decode_step", "serve.run"}
    steps = [e["args"] for e in spans if e["name"] == "decode_step"]
    assert [a["step"] for a in steps] == list(range(rt.steps))

    snap = reg.snapshot()
    assert snap["serve.preemptions"] == rt.scheduler.preemptions
    assert snap["serve.tokens_emitted"] == sum(len(r.out_tokens)
                                               for r in reqs)
    assert snap["serve.requests_retired"] == len(reqs)
    assert snap["serve.ttft_seconds"]["count"] == len(reqs)
    assert snap["serve.resumes"] > 0
    assert snap["serve.pool_free_blocks"] == sc.num_blocks
    # run()'s ITL figures are np.percentile's, bit for bit
    itl = [dt for r in reqs for dt in r.itl]
    assert out["itl_p50_s"] == float(np.percentile(itl, 50))
    assert out["itl_p99_s"] == float(np.percentile(itl, 99))
    assert "live_occupancy" in rt.metrics_snapshot()


@pytest.fixture(scope="module")
def quant_runs():
    """qwen2 smoke quantized plain, traced, and journaled-killed-resumed
    under a tracer (comq_blocked, 4-bit per-channel, 1 sweep)."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                     order="greedy")
    ref = quantize_model(params, cfg, BuildPlan(), tokens, spec,
                         method="comq_blocked")
    tr, reg = Tracer(run="q"), MetricsRegistry(run="q")
    obs = quantize_model(params, cfg, BuildPlan(), tokens, spec,
                         method="comq_blocked", tracer=tr, metrics=reg)
    return cfg, params, tokens, spec, ref, obs, tr, reg


def _qpk_bytes(q, path):
    save_packed_ckpt(str(path), pack_tree(q["__qlayers__"]))
    return path.read_bytes()


def test_disabled_tracer_quantize_bit_identical_packed_bytes(quant_runs,
                                                             tmp_path):
    """A live tracer and registry change no code: the .qpk bytes and the
    report rows equal the uninstrumented run's; only the span-measured
    wall_seconds are added."""
    _, _, _, _, (q_ref, rep_ref), (q_obs, rep_obs), tr, reg = quant_runs
    assert _qpk_bytes(q_ref, tmp_path / "ref.qpk") == \
        _qpk_bytes(q_obs, tmp_path / "obs.qpk")

    def rows(rep):
        return [(lr.layer, lr.name, lr.err_before, lr.err_after)
                for lr in rep.layers]
    assert rows(rep_ref) == rows(rep_obs)
    assert all(lr.wall_seconds == 0.0 for lr in rep_ref.layers)
    assert all(lr.wall_seconds > 0.0 for lr in rep_obs.layers)
    assert sum(lr.wall_seconds for lr in rep_obs.layers) <= \
        rep_obs.wall_seconds
    assert all(lr.seconds == lr.dispatch_seconds for lr in rep_obs.layers)

    spans = [e for e in tr.events if e["ph"] == "X"]
    assert [e["args"] for e in spans if e["name"] == "layer"] == [
        {"layer": 0, "schedule": "staged"},
        {"layer": 1, "schedule": "staged"}]
    solves = [e for e in spans if e["name"] == "leaf_solve"]
    assert [e["args"]["tap"] for e in solves] == [
        "attn_in", "wo_in", "mlp_in", "down_in"] * 2
    # each leaf's wall is its group's share of the span, read just before
    # the span closes
    by_group = {(e["args"]["layer"], e["args"]["leaves"]): e["dur"] / 1e6
                for e in solves}
    for (layer, leaves), dur in by_group.items():
        names = leaves.split(",")
        walls = [lr.wall_seconds for lr in rep_obs.layers
                 if lr.layer == layer and lr.name in names]
        assert len(walls) == len(names) and len(set(walls)) == 1
        assert 0.0 < walls[0] * len(names) <= dur
    snap = reg.snapshot()
    assert snap["quant.layers_done"] == 2.0
    assert snap["quant.leaves_solved"] == len(rep_obs.layers) == 14
    assert snap["quant.resumed_leaves"] == snap["quant.guard_events"] == 0
    for h in ("quant.leaf_err_after", "quant.leaf_dispatch_seconds",
              "quant.leaf_wall_seconds"):
        assert snap[h]["count"] == 14


def test_resumed_walk_counts_and_spans(quant_runs, tmp_path):
    """A journaled walk killed after layer 0 and resumed under a tracer:
    the resumed layer's leaves are counted as resumed, not solved, get no
    leaf_solve span and a wall of 0.0, and the codes equal the clean
    run's."""
    cfg, params, tokens, spec, (q_ref, _), *_ = quant_runs
    jd = str(tmp_path / "j")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, BuildPlan(), tokens, spec,
                       method="comq_blocked", journal=jd,
                       injector=FaultInjector({"kill": [1]}))
    tr, reg = Tracer(run="resume"), MetricsRegistry(run="resume")
    q, rep = quantize_model(params, cfg, BuildPlan(), tokens, spec,
                            method="comq_blocked", journal=jd, resume=True,
                            tracer=tr, metrics=reg)
    assert _qpk_bytes(q, tmp_path / "r.qpk") == \
        _qpk_bytes(q_ref, tmp_path / "ref.qpk")
    snap = reg.snapshot()
    assert rep.resumed_leaves == snap["quant.resumed_leaves"] == 7
    assert snap["quant.leaves_solved"] == 7
    assert snap["quant.layers_done"] == 2
    solves = [e["args"]["layer"] for e in tr.events
              if e["name"] == "leaf_solve"]
    assert solves == [1] * 4
    assert all((lr.wall_seconds > 0.0) == (lr.layer == 1)
               for lr in rep.layers)


# ---------------------------------------------------------------------------
# heartbeat snapshots, the CLIs, the serve launcher under a kill
# ---------------------------------------------------------------------------

def test_heartbeat_metrics_snapshot(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=0)
    hb.beat(3)
    rec = json.load(open(hb.path))
    assert rec["step"] == 3 and "metrics" not in rec
    reg = MetricsRegistry(run="hb")
    reg.counter("quant.layers_done").inc(4)
    hb.beat(4, metrics=reg.snapshot())
    rec = json.load(open(hb.path))
    assert rec["metrics"]["quant.layers_done"] == 4.0
    alive = Heartbeat.alive_hosts(str(tmp_path))
    assert alive[0]["metrics"]["quant.layers_done"] == 4.0


def _synthetic_run_dir(tmp_path):
    tr = Tracer(run="synthetic")
    with tr.span("decode_step", step=0):
        pass
    for e in [_rev("submit", 1, rid=0, prompt_len=4, max_new_tokens=1),
              _rev("admit", 2, rid=0, slot=0, resumed=False, prefill_len=4),
              _rev("first_token", 3, rid=0, token=7),
              _rev("token", 3, rid=0, i=0, token=7),
              _rev("retire", 4, rid=0, reason="length", new_tokens=1)]:
        tr._events.append(("i", e["name"], "request", e["ts"], 1, e["args"]))
    tr.save(next_trace_path(str(tmp_path), "serve"))
    reg = MetricsRegistry(run="synthetic")
    reg.counter("serve.tokens_emitted").inc()
    reg.histogram("serve.itl_seconds").observe(0.01)
    reg.dump_jsonl(str(tmp_path / "metrics.jsonl"))
    return tmp_path


def test_report_cli_smoke(tmp_path, capsys):
    run_dir = _synthetic_run_dir(tmp_path)
    assert obs_report.main([str(run_dir)]) == 0
    out = capsys.readouterr().out
    assert "== spans ==" in out and "decode_step" in out
    assert "== requests ==" in out and "== metrics ==" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert obs_report.main([str(empty)]) == 1


def test_validate_cli_timelines(tmp_path, capsys):
    run_dir = _synthetic_run_dir(tmp_path)
    trace = str(run_dir / "serve.g0.trace.json")
    assert obs_validate.main(["--timelines", trace]) == 0
    assert obs_validate.main(["--timelines", "--require-preempt",
                              trace]) == 1
    (tmp_path / "bad.trace.json").write_text("{")
    assert obs_validate.main([str(tmp_path / "bad.trace.json")]) == 1
    capsys.readouterr()


def test_serve_launcher_kill_restart_trace(tmp_path):
    """The serve launcher journaled, killed inside its staggered build and
    restarted under one tracer: the merged timelines validate, every
    request is replayed to completion, and each request's tokens equal
    the uninterrupted run's."""
    common = ["--arch", ARCH, "--smoke", "--device", "cpu",
              "--num-requests", "4", "--stagger", "2", "--prompt-len", "8",
              "--max-new", "6"]
    launch_serve.main(common + ["--trace", str(tmp_path / "ref")])
    out = launch_serve.main(common + [
        "--journal", str(tmp_path / "j"), "--inject", "kill:3",
        "--restarts", "2", "--trace", str(tmp_path / "killed")])
    assert [tuple(f) for f in out["faults_fired"]] == [("kill", 3)]

    def timelines(d):
        paths = sorted(str(p) for p in d.glob("*.trace.json"))
        assert paths and obs_validate.main(["--timelines"] + paths) == 0
        evs = []
        for p in paths:
            evs += json.loads(open(p).read())["traceEvents"]
        return reconstruct_timelines(evs)

    ref, killed = timelines(tmp_path / "ref"), timelines(tmp_path / "killed")
    assert sorted(ref) == sorted(killed) == [0, 1, 2, 3]
    for rid, tl in killed.items():
        assert validate_timeline(tl) == [] and tl.complete
        assert tl.tokens == ref[rid].tokens and len(tl.tokens) == 6
