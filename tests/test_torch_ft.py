"""The port's fault-tolerance runtime (repro_torch.ft) against the JAX
package's (repro.ft): heartbeats and recovery plans, straggler detection,
the restart supervisor (budget, exception filter, progress reset, capped
backoff), the fault injector (its parse and its seeded schedules equal
JAX's), and the JSONL journal discipline (crc per line, torn tail, seq
across reopens), with request journals read across the two packages.
Plain Python: no model runs here."""
import json
import os
import time

import numpy as np
import pytest

from repro.ft import FaultInjector as JFaultInjector
from repro.ft import Journal as JJournal
from repro.ft.inject import FAULT_POINTS as JFAULT_POINTS
from repro.serve.scheduler import Request as JRequest
from repro_torch.ft import (FaultInjector, Heartbeat, InjectedFault, Journal,
                            JournalCorrupt, SimulatedKill, Watchdog,
                            plan_recovery, run_with_restarts)
from repro_torch.ft.inject import FAULT_POINTS
from repro_torch.serve.scheduler import Request


# ---------------------------------------------------------------------------
# watchdog, heartbeat, restarts (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    wd = Watchdog(straggler_factor=3.0, warmup_steps=1)
    for i in range(6):
        wd.step_start()
        time.sleep(0.001)
        wd.step_end(i)
    wd.step_start()
    time.sleep(0.05)
    ev = wd.step_end(99)
    assert ev is not None and ev.step == 99


def test_heartbeat_and_recovery_plan(tmp_path):
    hb0 = Heartbeat(str(tmp_path), 0)
    hb1 = Heartbeat(str(tmp_path), 1)
    hb0.beat(10)
    hb1.beat(10, metrics={"retired": 3})
    plan = plan_recovery(str(tmp_path), expected_hosts=4,
                         latest_ckpt_step=10, dead_after_s=60)
    assert plan.healthy_hosts == [0, 1]
    assert plan.lost_hosts == [2, 3]
    assert plan.resume_step == 10
    # the JAX package reads the port's heartbeat files
    from repro.ft import Heartbeat as JHeartbeat
    alive = JHeartbeat.alive_hosts(str(tmp_path), dead_after_s=60)
    assert sorted(alive) == [0, 1] and alive[1]["metrics"] == {"retired": 3}


def test_restart_budget_exhausted():
    calls = {"n": 0}

    def attempt(_):
        calls["n"] += 1
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        run_with_restarts(attempt, lambda: None, max_restarts=2)
    assert calls["n"] == 3


def test_restart_only_listed_exceptions():
    calls = {"n": 0}

    def attempt(_):
        calls["n"] += 1
        raise ValueError("not retryable here")

    with pytest.raises(ValueError):
        run_with_restarts(attempt, lambda: None, max_restarts=5,
                          exceptions=(RuntimeError,))
    assert calls["n"] == 1
    calls["n"] = 0
    with pytest.raises(ValueError):
        run_with_restarts(attempt, lambda: None, max_restarts=2,
                          exceptions=(RuntimeError, ValueError))
    assert calls["n"] == 3


def test_restart_budget_resets_on_progress():
    state = {"calls": 0, "step": 0}

    def attempt(_):
        state["calls"] += 1
        state["step"] += 1
        if state["calls"] < 7:
            raise RuntimeError("crash after progress")
        return state["step"]

    assert run_with_restarts(attempt, lambda: state["step"],
                             max_restarts=1) == 7
    assert state["calls"] == 7


def test_restart_backoff_capped_exponential():
    sleeps = []

    def attempt(_):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError):
        run_with_restarts(attempt, lambda: None, max_restarts=4,
                          backoff_s=1.0, backoff_cap_s=4.0,
                          sleep_fn=sleeps.append)
    assert sleeps == [1.0, 2.0, 4.0, 4.0]


def test_injected_faults_are_runtime_errors():
    """The supervisors restart on RuntimeError: both injected kinds are
    one, and are told apart by type."""
    assert issubclass(InjectedFault, RuntimeError)
    assert issubclass(SimulatedKill, RuntimeError)
    assert not issubclass(SimulatedKill, InjectedFault)


def test_heartbeat_atomic_publish(tmp_path, monkeypatch):
    """A crash mid-beat leaves the previous heartbeat intact and no temp
    file behind."""
    import json as _json

    hb = Heartbeat(str(tmp_path), 0)
    hb.beat(10)
    real_dump = _json.dump

    def exploding_dump(obj, f, **kw):
        f.write('{"step": 11, "ti')
        raise OSError("disk full mid-write")

    monkeypatch.setattr(_json, "dump", exploding_dump)
    with pytest.raises(OSError):
        hb.beat(11)
    monkeypatch.setattr(_json, "dump", real_dump)
    with open(hb.path) as f:
        assert _json.load(f)["step"] == 10
    assert 0 in Heartbeat.alive_hosts(str(tmp_path), dead_after_s=60)
    assert os.listdir(str(tmp_path)) == ["heartbeat_0"]


def test_heartbeat_reader_never_sees_torn_json(tmp_path):
    hb = Heartbeat(str(tmp_path), 3)
    for step in range(50):
        hb.beat(step)
        alive = Heartbeat.alive_hosts(str(tmp_path), dead_after_s=60)
        assert 3 in alive and alive[3]["step"] == step


# ---------------------------------------------------------------------------
# the fault injector, against JAX's
# ---------------------------------------------------------------------------

def test_fault_points_match_jax():
    assert FAULT_POINTS == JFAULT_POINTS
    assert len(FAULT_POINTS) == 8


def test_fault_injector_schedule_and_parse():
    inj = FaultInjector.parse("page_alloc:2+4,kill:3")
    hits = [inj.fire("page_alloc") for _ in range(5)]
    assert hits == [False, True, False, True, False]
    assert not inj.fire("decode_step")
    with pytest.raises(SimulatedKill):
        for _ in range(3):
            inj.check("kill", SimulatedKill)
    assert inj.fired == [("page_alloc", 2), ("page_alloc", 4), ("kill", 3)]
    a = FaultInjector.random(0, {"x": 0.3}, horizon=50).schedule
    b = FaultInjector.random(0, {"x": 0.3}, horizon=50).schedule
    assert a == b and a["x"]
    with pytest.raises(ValueError, match="decode-step"):
        FaultInjector.parse("decode-step:3")
    with pytest.raises(ValueError, match="point:occurrence"):
        FaultInjector.parse("kill")


@pytest.mark.parametrize("seed,rates,horizon", [
    (0, {"decode_step": 0.1}, 10_000),
    (7, {"kill": 0.02, "page_alloc": 0.3, "callback": 0.5}, 400),
    (123, {"leaf_solve": 0.05, "nan_tap": 0.01, "gram_accumulate": 0.2},
     1000),
])
def test_random_schedule_matches_jax(seed, rates, horizon):
    """One seed and one set of rates give JAX's schedule, occurrence for
    occurrence, and the same firing sequence."""
    ours = FaultInjector.random(seed, rates, horizon=horizon)
    theirs = JFaultInjector.random(seed, rates, horizon=horizon)
    assert ours.schedule == theirs.schedule
    for point in sorted(rates):
        for _ in range(horizon):
            assert ours.fire(point) == theirs.fire(point)
    assert ours.fired == theirs.fired


@pytest.mark.parametrize("spec", ["page_alloc:3+7,kill:5", "kill:2",
                                  "leaf_solve:3,ckpt_write:1,nan_tap:1+2",
                                  " decode_step:1 , callback:2+2 "])
def test_parse_matches_jax(spec):
    assert FaultInjector.parse(spec).schedule == \
        JFaultInjector.parse(spec).schedule


# ---------------------------------------------------------------------------
# the request journal (tests/test_serve_faults.py, journal unit tests)
# ---------------------------------------------------------------------------

def _fake_req(rid, prompt=(1, 2, 3), seed=7, cls=Request, **kw):
    r = cls(prompt=np.asarray(prompt, np.int32), max_new_tokens=4,
            seed=seed, **kw)
    r.rid = rid
    return r


def test_journal_roundtrip_classifies_inflight(tmp_path):
    j = Journal(str(tmp_path))
    a, b = _fake_req(0), _fake_req(1, prompt=(9, 8), priority=2)
    j.record_submit(a)
    j.record_submit(b)
    j.record_first_token(a, 42)
    a.out_tokens = [42, 43]
    a.finish_reason = "length"
    j.record_retire(a)
    j.close()
    st = Journal.replay(str(tmp_path))
    assert set(st.completed) == {0} and set(st.inflight) == {1}
    assert st.completed_tokens(0) == [42, 43]
    assert st.first_tokens[0] == 42
    assert st.inflight[1]["priority"] == 2 and st.inflight[1]["seed"] == 7
    assert st.max_rid == 1


def test_journal_torn_tail_dropped_but_midfile_corruption_raises(tmp_path):
    j = Journal(str(tmp_path))
    j.record_submit(_fake_req(0))
    j.record_submit(_fake_req(1))
    j.close()
    path = os.path.join(str(tmp_path), "requests.jsonl")
    with open(path, "a") as f:
        f.write('{"ev": "retire", "rid": 1, "tok')
    st = Journal.replay(str(tmp_path))
    assert set(st.inflight) == {0, 1}
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join([lines[0], lines[2], lines[1]]) + "\n")
    with pytest.raises(JournalCorrupt):
        Journal.replay(str(tmp_path))


def test_journal_reopen_truncates_torn_tail_before_append(tmp_path):
    j = Journal(str(tmp_path))
    j.record_submit(_fake_req(0))
    j.close()
    path = os.path.join(str(tmp_path), "requests.jsonl")
    with open(path, "a") as f:
        f.write('{"ev": "retire", "rid": 0, "tok')
    j2 = Journal(str(tmp_path))
    r = _fake_req(0)
    r.out_tokens = [5]
    r.finish_reason = "length"
    j2.record_retire(r)
    j2.close()
    st = Journal.replay(str(tmp_path))
    assert not st.inflight and st.completed_tokens(0) == [5]
    with open(path, "w") as f:
        f.write('{"ev": "sub')
    Journal(str(tmp_path)).close()
    assert not Journal.replay(str(tmp_path)).records


def test_journal_seq_monotonic_across_reopen(tmp_path):
    j = Journal(str(tmp_path))
    j.record_submit(_fake_req(0))
    j.record_submit(_fake_req(1))
    j.close()
    j2 = Journal(str(tmp_path))
    j2.record_submit(_fake_req(2))
    j2.close()
    seqs = [r["seq"] for r in Journal.replay(str(tmp_path)).records]
    assert seqs == [0, 1, 2]


def test_journal_crc_rejects_bitflip(tmp_path):
    j = Journal(str(tmp_path))
    j.record_submit(_fake_req(0))
    j.record_submit(_fake_req(1))
    j.close()
    path = os.path.join(str(tmp_path), "requests.jsonl")
    lines = open(path).read().splitlines()
    flipped = lines[0].replace('"rid": 0', '"rid": 5')
    with open(path, "w") as f:
        f.write("\n".join([flipped, lines[1]]) + "\n")
    with pytest.raises(JournalCorrupt):
        Journal.replay(str(tmp_path))


def test_journal_dedup_submit_and_last_retire_wins(tmp_path):
    j = Journal(str(tmp_path))
    r = _fake_req(0)
    j.record_submit(r)
    j.record_submit(r)
    r.out_tokens = [1]
    r.finish_reason = "length"
    j.record_retire(r)
    r.out_tokens = [1, 2]
    j.record_retire(r)
    j.close()
    st = Journal.replay(str(tmp_path))
    assert not st.inflight and st.completed_tokens(0) == [1, 2]


def _write_lifecycle(journal_cls, req_cls, directory):
    """Three requests: 0 retired, 1 preempted and resumed in flight, 2
    submitted only; then a torn tail."""
    j = journal_cls(directory)
    reqs = [_fake_req(i, prompt=(i, i + 1), cls=req_cls, priority=i % 2,
                      stop_tokens=(9,)) for i in range(3)]
    for r in reqs:
        j.record_submit(r)
    j.record_first_token(reqs[0], 11)
    j.record_first_token(reqs[1], 12)
    reqs[1].out_tokens = [12]
    j.record_preempt(reqs[1])
    j.record_resume(reqs[1])
    reqs[0].out_tokens = [11, 9]
    reqs[0].finish_reason = "stop_token"
    j.record_retire(reqs[0])
    j.record_replayed(2)
    j.close()
    with open(os.path.join(directory, "requests.jsonl"), "a") as f:
        f.write('{"ev": "retire", "rid": 1')


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_request_journal_reads_across_packages(tmp_path, writer):
    """A requests.jsonl written by either package replays to the same
    completed and in-flight sets, records and seqs in both."""
    if writer == "port":
        _write_lifecycle(Journal, Request, str(tmp_path))
    else:
        _write_lifecycle(JJournal, JRequest, str(tmp_path))
    ours = Journal.replay(str(tmp_path))
    theirs = JJournal.replay(str(tmp_path))
    assert ours.completed == theirs.completed
    assert ours.inflight == theirs.inflight
    assert ours.first_tokens == theirs.first_tokens == {0: 11, 1: 12}
    assert ours.max_rid == theirs.max_rid == 2
    assert ours.records == theirs.records
    assert set(ours.completed) == {0} and set(ours.inflight) == {1, 2}
    assert [r["seq"] for r in ours.records] == list(range(9))
    line = open(os.path.join(str(tmp_path), "requests.jsonl")).readline()
    assert set(json.loads(line)) == {"ev", "seq", "rid", "prompt",
                                     "max_new_tokens", "temperature",
                                     "top_k", "top_p", "stop_tokens",
                                     "priority", "seed", "crc"}
