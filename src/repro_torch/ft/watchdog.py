"""Fault-tolerance runtime (port of `repro.ft.watchdog`): heartbeats,
straggler detection, restart policy. Plain Python.

* **heartbeat**: each host runs a `Heartbeat`, a file per host that is
  republished atomically (tmp + fsync + rename) at each beat; a beat older
  than `dead_after_s` marks the host dead.
* **straggler**: the trainer's `Watchdog` flags a step slower than
  `straggler_factor` × the EMA step time as a `StragglerEvent`.
* **recovery**: `plan_recovery` returns the restart decision (resume
  step, healthy and lost hosts).
* **restart**: `run_with_restarts` wraps a unit of work (a quantize walk
  resumed from its journal, a serving runtime recovered from its request
  log, a training loop from its checkpoint) and restarts it up to
  `max_restarts` times without progress.

Both launchers use `Heartbeat` and `run_with_restarts`; `Watchdog` and
`plan_recovery` serve the trainer.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Type


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    ema: float


class Watchdog:
    def __init__(self, straggler_factor: float = 3.0, ema_decay: float = 0.9,
                 warmup_steps: int = 3):
        self.factor = straggler_factor
        self.decay = ema_decay
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.count = 0
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.time()

    def step_end(self, step: int) -> Optional[StragglerEvent]:
        dt = time.time() - self._t0
        self.count += 1
        ev = None
        if self.ema is not None and self.count > self.warmup \
                and dt > self.factor * self.ema:
            ev = StragglerEvent(step, dt, self.ema)
            self.events.append(ev)
        self.ema = dt if self.ema is None else \
            self.decay * self.ema + (1 - self.decay) * dt
        return ev


class Heartbeat:
    """File-based host liveness (shared-filesystem clusters)."""

    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"heartbeat_{host_id}")
        os.makedirs(directory, exist_ok=True)
        self.host_id = host_id

    def beat(self, step: int, metrics: Optional[Dict] = None):
        # atomic publish: write the record to a temp file and rename it
        # over the live path, so a concurrent reader can never observe a
        # truncated JSON document (it sees either the old beat or the new
        # one — a torn read used to be swallowed as a dead host).
        # `metrics` is an optional JSON-able health snapshot (e.g.
        # Runtime.metrics_snapshot(): retired count, live occupancy,
        # last guard event) published under a "metrics" key so the
        # watchdog file is inspectable mid-run — liveness readers that
        # only look at step/time are unaffected.
        rec: Dict = {"step": step, "time": time.time()}
        if metrics:
            rec["metrics"] = metrics
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def alive_hosts(directory: str,
                    dead_after_s: float = 60.0) -> Dict[int, Dict]:
        out = {}
        now = time.time()
        if not os.path.isdir(directory):
            return out
        for name in os.listdir(directory):
            if not name.startswith("heartbeat_"):
                continue
            try:
                with open(os.path.join(directory, name)) as f:
                    info = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if now - info.get("time", 0) <= dead_after_s:
                out[int(name.split("_")[1])] = info
        return out


@dataclass
class RecoveryPlan:
    resume_step: Optional[int]
    healthy_hosts: List[int]
    lost_hosts: List[int]


def plan_recovery(heartbeat_dir: str, expected_hosts: int,
                  latest_ckpt_step: Optional[int],
                  dead_after_s: float = 60.0) -> RecoveryPlan:
    alive = Heartbeat.alive_hosts(heartbeat_dir, dead_after_s)
    healthy = sorted(alive)
    lost = [h for h in range(expected_hosts) if h not in alive]
    return RecoveryPlan(resume_step=latest_ckpt_step, healthy_hosts=healthy,
                        lost_hosts=lost)


def run_with_restarts(work_fn: Callable[[Optional[int]], int],
                      latest_step_fn: Callable[[], Optional[int]],
                      max_restarts: int = 3,
                      exceptions: Tuple[Type[BaseException], ...]
                      = (RuntimeError,),
                      backoff_s: float = 0.0,
                      backoff_cap_s: float = 30.0,
                      sleep_fn: Callable[[float], None] = time.sleep) -> int:
    """Supervisor loop: `work_fn(resume_point) -> result`, restarted from
    `latest_step_fn()` after each failure.

    Generalized beyond training (the serving runtime's crash-replay
    supervisor uses it with the journal's retired-request count as the
    progress signal): only exception types in `exceptions` trigger a
    restart — anything else propagates immediately; the attempt budget
    *resets whenever `latest_step_fn()` advances* between failures, so
    `max_restarts` bounds consecutive no-progress crashes rather than
    total lifetime failures; retries back off exponentially
    (`backoff_s · 2^(attempt-1)`, capped at `backoff_cap_s`; 0 disables —
    `sleep_fn` is injectable for tests)."""
    attempts = 0
    last_progress = latest_step_fn()
    while True:
        try:
            return work_fn(latest_step_fn())
        except exceptions:
            progress = latest_step_fn()
            if progress is not None and (last_progress is None
                                         or progress > last_progress):
                attempts = 0       # forward progress: reset the budget
                last_progress = progress
            attempts += 1
            if attempts > max_restarts:
                raise
            if backoff_s > 0.0:
                sleep_fn(min(backoff_s * 2.0 ** (attempts - 1),
                             backoff_cap_s))
