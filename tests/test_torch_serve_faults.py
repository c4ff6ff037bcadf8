"""Fault-tolerant serving in the port (repro_torch.serve.Runtime with
repro_torch.ft), mirroring tests/test_serve_faults.py: crash replay
through `recover_runtime` gives every request the uninterrupted run's
tokens (none lost, none re-run, none duplicated), also after a crash
during recovery, under the supervisor and inside the launcher's staggered
build; decode-step, page-alloc and callback faults leave the streams
intact. Against the JAX package: a recovered port run's greedy tokens
equal JAX's uninterrupted run on the same params, and each package's
request journal replays in the other to the same completed and in-flight
sets."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.ft import FaultInjector as JFaultInjector
from repro.ft import Journal as JJournal
from repro.ft import SimulatedKill as JSimulatedKill
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.serve import Runtime as JRuntime
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.ft import (FaultInjector, InjectedFault, Journal,
                            SimulatedKill, run_with_restarts)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import BuildPlan
from repro_torch.serve import Runtime, ServeConfig, recover_runtime

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SC = dict(max_slots=3, block_size=8, num_blocks=24, buckets=(8, 16, 32),
          max_blocks_per_slot=6)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    plan = JPlan(remat=False, cache_dtype=jnp.float32)
    return cfg, plan, jax_init(jax.random.PRNGKey(0), cfg, plan)


@pytest.fixture(scope="module")
def setup(jax_setup):
    """The port on the JAX init (converted through numpy), f32 compute."""
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    return cfg, params_from_numpy(jax.device_get(jax_setup[2]), "cpu")


def _plan(kv_bits=0):
    return BuildPlan(cache_dtype=torch.float32, kv_bits=kv_bits)


def _sc(**kw):
    return ServeConfig(**{**SC, **kw})


def _runtime(setup, plan=None, **kw):
    cfg, params = setup
    return Runtime(params, cfg, plan or _plan(), _sc(), device="cpu", **kw)


def _recover(setup, jd, plan=None, **kw):
    cfg, params = setup
    return recover_runtime(params, cfg, plan or _plan(), jd, _sc(),
                           device="cpu", **kw)


def _prompts(n, seed=23, lo=6, hi=15):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (int(n_),)).astype(np.int32)
            for n_ in rs.randint(lo, hi, n)]


def _solo(setup, prompts, max_new, plan=None, **kw):
    return [list(t) for t in _runtime(setup, plan).generate(
        prompts, max_new_tokens=max_new, **kw)]


# ---------------------------------------------------------------------------
# crash -> recover_runtime replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [0, 8])
def test_crash_replay_token_identity(setup, tmp_path, kv_bits):
    """Kill mid-decode; recovery finishes every in-flight request with the
    uninterrupted run's tokens (bf16 or int8 pages alike)."""
    prompts = _prompts(3)
    plan = _plan(kv_bits)
    solo = _solo(setup, prompts, 8, plan)
    rt = _runtime(setup, plan, journal=Journal(str(tmp_path)),
                  injector=FaultInjector({"kill": {4}}))
    reqs = [rt.submit(p, max_new_tokens=8) for p in prompts]
    with pytest.raises(SimulatedKill):
        rt.run()
    assert any(0 < len(r.out_tokens) < 8 for r in reqs)
    rt2, st = _recover(setup, str(tmp_path), plan)
    assert set(st.inflight) == {r.rid for r in reqs} and not st.completed
    replayed = {r.rid: r for r in rt2.scheduler.queue}
    assert sorted(replayed) == sorted(r.rid for r in reqs)
    rt2.run()
    for r, want in zip(reqs, solo):
        assert replayed[r.rid].out_tokens == want
    final = Journal.replay(str(tmp_path))
    assert not final.inflight and set(final.completed) == set(replayed)
    evs = [rec["ev"] for rec in final.records]
    assert evs.count("replayed") == 3 and evs.count("submit") == 3


def test_crash_replay_skips_retired_requests(setup, tmp_path):
    short = np.arange(5, dtype=np.int32)
    long_ = _prompts(1)[0]
    rt = _runtime(setup, journal=Journal(str(tmp_path)),
                  injector=FaultInjector({"kill": {6}}))
    r_short = rt.submit(short, max_new_tokens=2)
    r_long = rt.submit(long_, max_new_tokens=12)
    with pytest.raises(SimulatedKill):
        rt.run()
    assert r_short.state == "done"
    rt2, st = _recover(setup, str(tmp_path))
    assert set(st.completed) == {r_short.rid}
    assert st.completed_tokens(r_short.rid) == r_short.out_tokens
    assert set(st.inflight) == {r_long.rid}
    rt2.run()
    assert rt2.scheduler.completed[-1].out_tokens == \
        _solo(setup, [long_], 12)[0]
    assert len(rt2.scheduler.completed) == 1     # the retired one not re-run


def test_double_crash_recovery_converges(setup, tmp_path):
    prompts = _prompts(2)
    solo = _solo(setup, prompts, 8)
    rt = _runtime(setup, journal=Journal(str(tmp_path)),
                  injector=FaultInjector({"kill": {3}}))
    rids = [rt.submit(p, max_new_tokens=8).rid for p in prompts]
    with pytest.raises(SimulatedKill):
        rt.run()
    rt2, _ = _recover(setup, str(tmp_path),
                      injector=FaultInjector({"kill": {2}}))
    with pytest.raises(SimulatedKill):
        rt2.run()
    rt2.journal.close()
    rt3, st = _recover(setup, str(tmp_path))
    assert sorted(st.inflight) == sorted(rids)
    rt3.run()
    done = {r.rid: r for r in rt3.scheduler.completed}
    for rid, want in zip(rids, solo):
        assert done[rid].out_tokens == want


def test_supervised_drain_with_restarts(setup, tmp_path):
    """The launcher-style supervisor drains through two kills with the
    retired count as the progress signal; the pool ends whole."""
    prompts = _prompts(3)
    solo = _solo(setup, prompts, 6)
    inj = FaultInjector({"kill": {2, 7}})
    state = {"first": True}

    def attempt(_):
        if state["first"]:
            state["first"] = False
            rt = _runtime(setup, journal=Journal(str(tmp_path)),
                          injector=inj)
            for p in prompts:
                rt.submit(p, max_new_tokens=6)
        else:
            rt, _ = _recover(setup, str(tmp_path), injector=inj)
        rt.run()
        return rt

    def progress():
        return len(Journal.replay(str(tmp_path)).completed)

    rt = run_with_restarts(attempt, progress, max_restarts=2,
                           exceptions=(SimulatedKill,))
    st = Journal.replay(str(tmp_path))
    assert not st.inflight and len(st.completed) == 3
    assert len(inj.fired) == 2
    for rid, want in enumerate(solo):
        assert st.completed_tokens(rid) == want
    assert rt.allocator.num_free == rt.allocator.num_blocks


LAUNCH = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
          "--num-requests", "3", "--prompt-len", "8", "--max-new", "4"]


def test_launcher_restart_covers_crash_during_staggered_build(
        tmp_path, capsys):
    """A kill while the launcher's build() is still submitting (staggered
    arrivals) restarts in resume mode: journaled submits replay under
    their rids, the never-journaled prompts are submitted anew, and the
    tokens equal an uninterrupted launch's."""
    clean = launch_serve.main(LAUNCH + ["--stagger", "1"])
    out = launch_serve.main(LAUNCH + [
        "--stagger", "1", "--journal", str(tmp_path), "--inject", "kill:1",
        "--restarts", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["faults_fired"] == [["kill", 1]]
    assert out["faults_fired"] == [("kill", 1)]
    assert len(out["prompt_lens"]) == 3
    st = Journal.replay(str(tmp_path))
    assert not st.inflight and sorted(st.completed) == [0, 1, 2]
    assert [st.completed_tokens(r)[:8] for r in range(3)][0] == \
        clean["sample"]
    assert [rec["rid"] for rec in st.records
            if rec["ev"] == "submit"] == [0, 1, 2]


def test_launcher_resume_after_an_unsupervised_crash(tmp_path):
    """Without --restarts the kill ends the launch; --resume then finishes
    exactly the in-flight requests from the journal."""
    with pytest.raises(SimulatedKill):
        launch_serve.main(LAUNCH + ["--journal", str(tmp_path), "--inject",
                                    "kill:3"])
    st = Journal.replay(str(tmp_path))
    assert st.inflight and not st.completed
    out = launch_serve.main(LAUNCH + ["--journal", str(tmp_path),
                                      "--resume"])
    assert out["requests"] == len(st.inflight)
    final = Journal.replay(str(tmp_path))
    assert not final.inflight and sorted(final.completed) == [0, 1, 2]
    with pytest.raises(SystemExit, match="need --journal"):
        launch_serve.main(LAUNCH + ["--resume"])


# ---------------------------------------------------------------------------
# in-process fault points
# ---------------------------------------------------------------------------

def test_decode_fault_retries_without_losing_requests(setup):
    prompts = _prompts(2)
    solo = _solo(setup, prompts, 6)
    rt = _runtime(setup, injector=FaultInjector({"decode_step": {2}}))
    reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
    with pytest.raises(InjectedFault):
        rt.run()
    rt.allocator.check_integrity()
    rt.run()
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_page_alloc_faults_keep_every_stream(setup):
    """Allocations reported failed with pages free (occurrences 2 and 4)
    back-pressure or preempt, and every request still gets its solo
    tokens."""
    prompts = _prompts(3, lo=9, hi=15)
    solo = _solo(setup, prompts, 8)
    inj = FaultInjector({"page_alloc": {2, 4}})
    rt = _runtime(setup, injector=inj)
    reqs = [rt.submit(p, max_new_tokens=8) for p in prompts]
    rt.run()
    assert inj.fired == [("page_alloc", 2), ("page_alloc", 4)]
    assert inj.counts["page_alloc"] > 4
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want
    rt.allocator.check_integrity()
    assert rt.allocator.num_free == rt.allocator.num_blocks


def test_callback_fault_contained_per_request(setup):
    prompts = _prompts(2)
    solo = _solo(setup, prompts, 6)
    rt = _runtime(setup, injector=FaultInjector({"callback": {2}}))
    seen = []
    reqs = [rt.submit(p, max_new_tokens=6,
                      stream_cb=lambda r, t: seen.append((r.rid, t)))
            for p in prompts]
    rt.run()
    errs = [e for r in reqs for e in r.cb_errors]
    assert len(errs) == 1 and isinstance(errs[0], InjectedFault)
    for r, want in zip(reqs, solo):
        assert r.out_tokens == want
    assert len(seen) == sum(len(r.out_tokens) for r in reqs) - 1


def test_crash_replay_of_seeded_sampling(setup, tmp_path):
    """temperature > 0: a crash-replayed stream redraws the uninterrupted
    run's samples (each a function of the request's seed and index)."""
    prompts = _prompts(2, lo=9, hi=15)
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=5)
    ref = _runtime(setup)
    want = [ref.submit(p, seed=100 + i, **kw) for i, p in enumerate(prompts)]
    ref.run()
    rt = _runtime(setup, journal=Journal(str(tmp_path)),
                  injector=FaultInjector({"kill": {5}}))
    for i, p in enumerate(prompts):
        rt.submit(p, seed=100 + i, **kw)
    with pytest.raises(SimulatedKill):
        rt.run()
    rt2, _ = _recover(setup, str(tmp_path))
    rt2.run()
    got = {r.rid: r.out_tokens for r in rt2.scheduler.completed}
    assert [got[r.rid] for r in want] == [r.out_tokens for r in want]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

PROMPTS_JAX = _prompts(3, seed=5)


@pytest.fixture(scope="module")
def jax_run(jax_setup, tmp_path_factory):
    """JAX's uninterrupted tokens for PROMPTS_JAX, and a JAX journal of the
    same traffic killed at step 4."""
    cfg, plan, params = jax_setup
    jsc = JServeConfig(**SC)
    solo = [list(map(int, t)) for t in JRuntime(params, cfg, plan, jsc)
            .generate(PROMPTS_JAX, max_new_tokens=8)]
    jd = str(tmp_path_factory.mktemp("jax_journal"))
    rt = JRuntime(params, cfg, plan, jsc, journal=JJournal(jd),
                  injector=JFaultInjector({"kill": {4}}))
    for p in PROMPTS_JAX:
        rt.submit(p, max_new_tokens=8)
    with pytest.raises(JSimulatedKill):
        rt.run()
    rt.journal.close()
    return solo, jd


def test_recovered_tokens_equal_jax_uninterrupted(setup, jax_run, tmp_path):
    """A port run killed at step 4 and recovered gives JAX's uninterrupted
    greedy tokens, and its journal replays in JAX to the same sets."""
    solo, _ = jax_run
    rt = _runtime(setup, journal=Journal(str(tmp_path)),
                  injector=FaultInjector({"kill": {4}}))
    for p in PROMPTS_JAX:
        rt.submit(p, max_new_tokens=8)
    with pytest.raises(SimulatedKill):
        rt.run()
    rt.journal.close()
    ours, theirs = Journal.replay(str(tmp_path)), JJournal.replay(
        str(tmp_path))
    assert ours.completed == theirs.completed
    assert ours.inflight == theirs.inflight and set(ours.inflight) == {
        0, 1, 2}
    rt2, _ = _recover(setup, str(tmp_path))
    rt2.run()
    got = {r.rid: r.out_tokens for r in rt2.scheduler.completed}
    assert [got[i] for i in range(3)] == solo
    final = JJournal.replay(str(tmp_path))
    assert not final.inflight and [final.completed_tokens(i)
                                   for i in range(3)] == solo


def test_port_recovers_a_jax_journal(setup, jax_run):
    """A request journal written by JAX's runtime (killed at step 4)
    replays in the port to JAX's sets, and the port's recover_runtime
    finishes it with JAX's uninterrupted tokens."""
    solo, jd = jax_run
    ours, theirs = Journal.replay(jd), JJournal.replay(jd)
    assert ours.completed == theirs.completed
    assert ours.inflight == theirs.inflight
    assert ours.first_tokens == theirs.first_tokens
    assert {rid: rec["prompt"] for rid, rec in ours.inflight.items()} == {
        i: p.tolist() for i, p in enumerate(PROMPTS_JAX)}
    rt, st = _recover(setup, jd)
    assert sorted(st.inflight) == [0, 1, 2]
    rt.run()
    rt.journal.close()
    got = {r.rid: r.out_tokens for r in rt.scheduler.completed}
    assert [got[i] for i in range(3)] == solo
