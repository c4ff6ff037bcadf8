"""Deterministic fault injection for the serving runtime and the
quantization pipeline (port of `repro.ft.inject`; plain Python and numpy).

A `FaultInjector` owns a set of named fault points; the runtime (and the
block allocator's `fail_hook`) and the pipeline call `fire(point)` at each
hook site, and the injector decides — from an explicit occurrence
schedule or a seeded Bernoulli draw fixed at construction — whether that
occurrence faults. Schedules are pure functions of the constructor
arguments (`random` draws from `np.random.RandomState`, as the JAX package
does, so one seed gives one schedule in both packages).

Fault points wired through serve/runtime.py:

* ``page_alloc``   — `BlockAllocator.alloc` reports exhaustion with pages
                     free: exercises backpressure and preemption.
* ``decode_step``  — raises `InjectedFault` immediately before the decode
                     step launches.
* ``callback``     — the per-token stream callback raises: contained on
                     the request (`Request.cb_errors`).
* ``kill``         — raises `SimulatedKill` between steps: a process
                     death; recovery goes through the request journal.

Pipeline fault points wired through core/pipeline.py (``kill`` is shared:
in the pipeline it fires between layers, after the layer's leaves are
journaled):

* ``gram_accumulate`` — raises `InjectedFault` right before a tap
                     group's Gram.
* ``leaf_solve``   — raises `InjectedFault` before a leaf's solve (one
                     occurrence per leaf, in walk order).
* ``ckpt_write``   — fires inside a leaf spill, after the tmp file is
                     written and fsynced but before the rename: the
                     torn-write window (`ckpt.save_packed_ckpt`'s
                     fault_cb).
* ``nan_tap``      — does not raise: poisons one entry of the tap with
                     NaN, exercising the numeric guards.

Usage::

    inj = FaultInjector({"page_alloc": [3, 7], "kill": [5]})
    inj = FaultInjector.random(seed=0, rates={"decode_step": 0.1})
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

# fault points with hook sites in serve/runtime.py or core/pipeline.py;
# parse() rejects anything else, so a typo'd --inject fails loudly
FAULT_POINTS = frozenset({"page_alloc", "decode_step", "callback", "kill",
                          "gram_accumulate", "leaf_solve", "ckpt_write",
                          "nan_tap"})


class InjectedFault(RuntimeError):
    """A seeded in-process fault."""


class SimulatedKill(RuntimeError):
    """A seeded process death: nothing cleans up; recovery must come from
    the journal."""


class FaultInjector:
    """Named fault points with deterministic firing schedules.

    `schedule` maps point name -> iterable of 1-based occurrence indices
    that fault. Occurrence counters persist for the injector's lifetime
    (across supervisor restarts), so "the 5th alloc ever" means exactly
    that even if the runtime is rebuilt around the same injector."""

    def __init__(self, schedule: Optional[Dict[str, Iterable[int]]] = None):
        self.schedule: Dict[str, set] = {
            k: set(int(i) for i in v) for k, v in (schedule or {}).items()}
        self.counts: Dict[str, int] = {}
        self.fired: List[tuple] = []       # (point, occurrence) audit log

    @classmethod
    def random(cls, seed: int, rates: Dict[str, float],
               horizon: int = 10_000) -> "FaultInjector":
        """Seeded Bernoulli schedule: occurrence i of `point` faults with
        probability rates[point], drawn over `horizon` occurrences at
        construction."""
        rs = np.random.RandomState(seed)
        schedule = {}
        for point in sorted(rates):
            draws = rs.random_sample(horizon) < rates[point]
            schedule[point] = [i + 1 for i in np.flatnonzero(draws)]
        return cls(schedule)

    @classmethod
    def parse(cls, spec: str) -> "FaultInjector":
        """CLI form: "point:occ[+occ...],point:occ", e.g.
        "page_alloc:3+7,kill:5" (the launchers' --inject)."""
        schedule: Dict[str, List[int]] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            point, _, occs = part.partition(":")
            if not occs:
                raise ValueError(f"--inject entry {part!r} needs "
                                 "point:occurrence[+occurrence...]")
            if point not in FAULT_POINTS:
                raise ValueError(
                    f"--inject point {point!r} is not a known fault point "
                    f"(choose from {', '.join(sorted(FAULT_POINTS))})")
            schedule.setdefault(point, []).extend(
                int(o) for o in occs.split("+"))
        return cls(schedule)

    def fire(self, point: str) -> bool:
        """Count one occurrence of `point`; True when it should fault."""
        n = self.counts.get(point, 0) + 1
        self.counts[point] = n
        hit = n in self.schedule.get(point, ())
        if hit:
            self.fired.append((point, n))
        return hit

    def check(self, point: str, exc=InjectedFault) -> None:
        """fire() and raise `exc` on a hit."""
        if self.fire(point):
            raise exc(f"injected fault at {point} occurrence "
                      f"{self.counts[point]}")
