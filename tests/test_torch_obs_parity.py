"""The port's observability against the JAX package's on the same params
and traffic (qwen2 smoke, f32): rebuilt request timelines, registry
counters and histogram counts, the quantize walk's span set, and each
package's validator and report CLI on the other package's files."""
import collections
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
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import report as jax_report
from repro.obs import validate as jax_validate
from repro.serve import Runtime as JRuntime
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.models import BuildPlan
from repro_torch.obs import (MetricsRegistry, Tracer, dedup_events,
                             next_trace_path, reconstruct_timelines)
from repro_torch.obs import report as port_report
from repro_torch.obs import validate as port_validate
from repro_torch.serve import Runtime, ServeConfig

torch.set_num_threads(2)

ARCH = "qwen2-7b"
# three requests over six 8-token pages: the pool preempts
SC = dict(max_slots=3, block_size=8, num_blocks=6, buckets=(8, 16, 32),
          max_blocks_per_slot=6)
MAX_NEW = 8
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
            order="greedy")


@pytest.fixture(scope="module")
def serve_runs():
    """The JAX Runtime and the port's on the JAX init, each with a live
    tracer and registry, on the same preempting traffic."""
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    plan = JPlan(remat=False, cache_dtype=jnp.float32)
    jparams = jax_init(jax.random.PRNGKey(0), cfg, plan)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (14, 9, 12)]
    jtr, jreg = JTracer(run="jax"), JRegistry(run="jax")
    jrt = JRuntime(jparams, cfg, plan, JServeConfig(**SC), tracer=jtr,
                   metrics=jreg)
    jreqs = [jrt.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    jrt.run()

    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    ttr, treg = Tracer(run="port"), MetricsRegistry(run="port")
    trt = Runtime(tparams, tcfg, BuildPlan(cache_dtype=torch.float32),
                  ServeConfig(**SC), tracer=ttr, metrics=treg, device="cpu")
    treqs = [trt.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    trt.run()
    assert jrt.scheduler.preemptions > 0
    return {"jax": (jtr, jreg, jreqs), "port": (ttr, treg, treqs)}


@pytest.fixture(scope="module")
def quant_runs():
    """One traced, metered quantize walk in each package, same weights and
    calibration tokens (comq_blocked, 4-bit per-channel, 1 sweep)."""
    jparams = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                      JPlan(remat=False)))
    tok = np.random.default_rng(0).integers(0, 256, (4, 64)).astype(np.int32)
    jtr, jreg = JTracer(run="jax"), JRegistry(run="jax")
    ttr, treg = Tracer(run="port"), MetricsRegistry(run="port")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, jrep = jax_quantize(jparams, jax_cfg(ARCH), JPlan(remat=False),
                               jnp.asarray(tok), JSpec(**SPEC),
                               method="comq_blocked", tracer=jtr,
                               metrics=jreg)
        _, trep = quantize_model(params_from_numpy(jparams, "cpu"),
                                 get_smoke_config(ARCH), BuildPlan(),
                                 torch.from_numpy(tok).long(),
                                 QuantSpec(**SPEC), method="comq_blocked",
                                 tracer=ttr, metrics=treg)
    return {"jax": (jtr, jreg, jrep), "port": (ttr, treg, trep)}


def _by_rid(events):
    out = collections.defaultdict(list)
    for e in dedup_events(events):
        out[e["args"]["rid"]].append(e["name"])
    return dict(out)


def test_timelines_match_jax(serve_runs):
    """Event kinds per rid (in time order), token values, preempt and
    resume counts and finish reasons agree; timestamps are not compared."""
    jtr, _, jreqs = serve_runs["jax"]
    ttr, _, treqs = serve_runs["port"]
    assert _by_rid(ttr.events) == _by_rid(jtr.events)
    jtl, ttl = reconstruct_timelines(jtr.events), \
        reconstruct_timelines(ttr.events)
    assert sorted(ttl) == sorted(jtl) == [r.rid for r in treqs]
    for rid in jtl:
        a, b = jtl[rid], ttl[rid]
        assert b.tokens == a.tokens
        assert (len(b.preempts), len(b.resumes)) == \
            (len(a.preempts), len(a.resumes))
        assert (b.finish_reason, b.new_tokens, b.prompt_len) == \
            (a.finish_reason, a.new_tokens, a.prompt_len)
    assert any(tl.preempts and tl.resumes for tl in ttl.values())
    assert [list(r.out_tokens) for r in treqs] == \
        [[int(t) for t in r.out_tokens] for r in jreqs]
    # the decode_step spans carry the same args
    steps = [[e["args"] for e in tr.events if e["name"] == "decode_step"]
             for tr in (jtr, ttr)]
    assert steps[0] == steps[1]


@pytest.mark.parametrize("run", ["serve", "quantize"])
def test_registries_match_jax(serve_runs, quant_runs, run):
    """Every instrument exists in both registries with the same kind;
    counters (and the serve gauges) are equal, histograms hold the same
    number of observations."""
    runs = serve_runs if run == "serve" else quant_runs
    jreg, treg = runs["jax"][1], runs["port"][1]
    ji, ti = jreg.instruments(), treg.instruments()
    assert sorted(ti) == sorted(ji)
    for name in ji:
        assert ti[name].kind == ji[name].kind, name
        if ji[name].kind == "histogram":
            assert ti[name].count == ji[name].count > 0, name
        elif ji[name].kind == "counter" or run == "serve":
            assert ti[name].value == ji[name].value, name
    if run == "quantize":
        rep = runs["port"][2]
        assert ti["quant.leaves_solved"].value == len(rep.layers) == 14
        assert ti["quant.layers_done"].value == 2


def _span_multiset(tracer):
    return collections.Counter(
        (e["name"], tuple(sorted(e["args"].items())))
        for e in tracer.events if e["ph"] == "X")


def test_quantize_spans_match_jax(quant_runs):
    jtr, _, jrep = quant_runs["jax"]
    ttr, _, trep = quant_runs["port"]
    assert _span_multiset(ttr) == _span_multiset(jtr)
    assert sum(_span_multiset(ttr).values()) == 2 + 8
    # the span-measured walls exist in both, and only there
    assert all(r.wall_seconds > 0 for r in trep.layers)
    assert all(r.wall_seconds > 0 for r in jrep.layers)


def _write(tmp_path, which, serve_runs, quant_runs):
    """Each run's trace and metrics files as the launchers write them."""
    dirs = {}
    for run, runs in (("serve", serve_runs), ("quantize", quant_runs)):
        tr, reg, _ = runs[which]
        d = tmp_path / which / run
        tr.save(next_trace_path(str(d), run))
        reg.dump_jsonl(str(d / "metrics.jsonl"))
        reg.dump_prometheus(str(d / "metrics.prom"))
        dirs[run] = d
    return dirs


@pytest.mark.parametrize("files,tools", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_files(tmp_path, capsys, serve_runs,
                                             quant_runs, files, tools):
    """JAX's validator (with --timelines --require-preempt on the serve
    trace) and report accept the port's files, and the port's accept
    JAX's."""
    dirs = _write(tmp_path, files, serve_runs, quant_runs)
    validate, report = ((jax_validate, jax_report) if tools == "jax"
                        else (port_validate, port_report))
    serve_trace = str(dirs["serve"] / "serve.g0.trace.json")
    quant_trace = str(dirs["quantize"] / "quantize.g0.trace.json")
    assert validate.main([quant_trace]) == 0
    assert validate.main(["--timelines", "--require-preempt",
                          serve_trace]) == 0
    assert validate.validate_trace_file(serve_trace) == []
    for d in dirs.values():
        assert report.main([str(d)]) == 0
    out = capsys.readouterr().out
    assert "3 request(s), " in out and "leaf_solve" in out
    assert "serve.tokens_emitted" in out


@pytest.mark.parametrize("run", ["serve", "quantize"])
def test_metrics_jsonl_keys_and_types_match_jax(tmp_path, serve_runs,
                                                quant_runs, run):
    recs = {}
    for which in ("jax", "port"):
        path = _write(tmp_path, which, serve_runs, quant_runs)[run] / \
            "metrics.jsonl"
        recs[which] = {r["name"]: r for r in map(
            json.loads, path.read_text().splitlines())}
    assert sorted(recs["port"]) == sorted(recs["jax"])
    for name, j in recs["jax"].items():
        t = recs["port"][name]
        assert sorted(t) == sorted(j), name
        assert {k: type(v) for k, v in t.items()} == \
            {k: type(v) for k, v in j.items()}, name
    prom = {w: (tmp_path / w / run / "metrics.prom").read_text()
            for w in ("jax", "port")}
    assert [ln for ln in prom["port"].splitlines() if ln.startswith("#")] \
        == [ln for ln in prom["jax"].splitlines() if ln.startswith("#")]
