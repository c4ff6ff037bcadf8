"""Structured tracing: nestable host spans → Chrome-trace JSON (port of
`repro.obs.trace`, the same events and file format).

`Tracer` collects two kinds of events:

* **spans** — `with tracer.span("leaf_solve", layer=3, name="wq"):`
  records a Chrome-trace complete ("X") event with epoch-µs start and a
  perf_counter-derived duration.  Spans nest; each thread gets its own
  `tid` lane so nesting renders correctly in Perfetto/chrome://tracing.
* **request events** — `tracer.request_event("submit", rid=4, ...)`
  records an instant ("i") event in the `request` category; these are
  the raw material `obs/timeline.py` reconstructs per-request serve
  timelines from (and dedups by rid across crash-replay restarts).

Device bridging: when a span is opened with `device=True` while a
`torch.profiler` is attached, the tracer also enters
`torch.profiler.record_function(label)`, a user annotation — so in a
profiler trace the host span brackets the CUDA kernels it launched (the
serve runtime's `decode_step`, the pipeline's `leaf_solve`). With no
profiler attached the annotation would record nothing, and entering it
costs ~10 µs: the span skips it.

Timestamps are epoch microseconds (`time.time()*1e6`) so traces written
by different processes — e.g. restart generations of a crash-replay run
— merge and order correctly; durations come from `perf_counter` deltas
so they are monotonic within a span.

Zero-cost-disabled rule: callers hold `tracer or NULL_TRACER`.  The null
tracer's `span()` returns one shared no-op context manager and its event
hooks return immediately — no allocation, no branching in callees.

Hot-path rule: a token event (once a live slot a decode step) leaves no
object for Python's cyclic collector behind: its fields go to a flat
list and a shared marker to the event list, so a long trace does not
make the collector's passes, which grow with the whole process's heap,
a cost of the step.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional


_TOKEN = "token"     # event-list marker: the next fields of Tracer._tokens


class _NullSpan:
    """Shared no-op span: `with NULL_TRACER.span(...)` costs two calls."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled tracer: every hook is a no-op returning a shared object."""
    __slots__ = ()
    enabled = False

    def span(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args: Any) -> None:
        return None

    def request_event(self, kind: str, rid: int, **args: Any) -> None:
        return None

    def token_event(self, rid: int, i: int, token: int,
                    ts_us: float) -> None:
        return None

    def save(self, path: str) -> None:   # pragma: no cover - never called
        return None


NULL_TRACER = _NullTracer()


class Span:
    """An open span; closing it appends one Chrome-trace "X" event."""
    __slots__ = ("_tracer", "name", "args", "_t0_epoch_us", "_t0_perf",
                 "_annotation")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 annotation: Any = None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._annotation = annotation
        self._t0_epoch_us = time.time() * 1e6
        self._t0_perf = time.perf_counter()

    def __enter__(self) -> "Span":
        if self._annotation is not None:
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        dur_us = (time.perf_counter() - self._t0_perf) * 1e6
        self._tracer._events.append(
            ("X", self.name, self._t0_epoch_us, dur_us,
             threading.get_ident(), self.args))
        return False

    @property
    def elapsed_s(self) -> float:
        """Seconds since the span opened (usable before close)."""
        return time.perf_counter() - self._t0_perf


class Tracer:
    """Collects trace events in memory; `save()` writes Chrome-trace JSON.

    Hot-path discipline (the §10.3 overhead budget): emit appends ONE
    compact tuple — no Chrome-trace dict is built until `events`/`save`
    materializes them, off the hot path. `list.append` is atomic under
    the GIL, so concurrent emitters need no lock; `events` snapshots via
    `list(...)` for the same reason.
    """
    enabled = True

    def __init__(self, run: str = "run", pid: Optional[int] = None):
        self.run = run
        self.pid = os.getpid() if pid is None else pid
        # raw entries: ("X", name, ts_us, dur_us, tid, args) for spans,
        # ("i", name, cat, ts_us, tid, args) for instants, _TOKEN for a
        # token event, whose (rid, i, token, ts_us, tid) are the next five
        # entries of _tokens
        self._events: List[Any] = []
        self._tokens: List[Any] = []

    # -- emission ------------------------------------------------------
    def span(self, name: str, *, device: bool = False, **args: Any) -> Span:
        """Open a nestable span. `device=True` additionally enters
        `torch.profiler.record_function(name)` so the label shows up as
        a user annotation around the span's kernels when a profiler is
        attached."""
        annotation = None
        if device and _profiling():
            annotation = _trace_annotation(name)
        return Span(self, name, args, annotation)

    def instant(self, name: str, **args: Any) -> None:
        self._events.append(("i", name, "instant", time.time() * 1e6,
                             threading.get_ident(), args))

    def request_event(self, kind: str, rid: int, **args: Any) -> None:
        """Instant event in the `request` category; the per-request
        timeline reconstruction keys off (kind, rid, args)."""
        a = {"rid": rid}
        a.update(args)
        self._events.append(("i", kind, "request", time.time() * 1e6,
                             threading.get_ident(), a))

    def token_event(self, rid: int, i: int, token: int,
                    ts_us: float) -> None:
        """Specialized `request_event("token", ...)` for the decode
        loop's once-per-token hot call: the caller passes the step's
        already-taken timestamp so N live slots share one clock read,
        and the kwargs plumbing is skipped. The fields are kept flat (see
        the module docstring); `events` builds the same event."""
        self._tokens.extend((rid, i, token, ts_us, threading.get_ident()))
        self._events.append(_TOKEN)

    # -- access / persistence -----------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        tokens, k = list(self._tokens), 0
        for ev in list(self._events):
            if ev is _TOKEN:
                rid, i, token, ts, tid = tokens[k:k + 5]
                k += 5
                out.append({"name": "token", "ph": "i", "cat": "request",
                            "s": "t", "ts": ts, "pid": self.pid, "tid": tid,
                            "args": {"rid": rid, "i": i, "token": token}})
            elif ev[0] == "X":
                _, name, ts, dur, tid, args = ev
                out.append({"name": name, "ph": "X", "cat": "span",
                            "ts": ts, "dur": dur, "pid": self.pid,
                            "tid": tid, "args": args})
            else:
                _, name, cat, ts, tid, args = ev
                out.append({"name": name, "ph": "i", "cat": cat, "s": "t",
                            "ts": ts, "pid": self.pid, "tid": tid,
                            "args": args})
        return out

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms",
                "otherData": {"run": self.run}}

    def save(self, path: str) -> None:
        """Write `{"traceEvents": [...]}` JSON. Appends never happen —
        each save is a full, self-contained snapshot (crash-replay
        restarts write distinct generation files and `obs/timeline.py`
        merges them)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def next_trace_path(directory: str, prefix: str) -> str:
    """Generation-unique trace filename `<prefix>.g<N>.trace.json` — each
    restart generation of a crash-replay run writes its own file and
    `obs/timeline.py` merges + dedups them by rid."""
    os.makedirs(directory, exist_ok=True)
    n = len([f for f in os.listdir(directory)
             if f.startswith(prefix + ".g") and f.endswith(".trace.json")])
    return os.path.join(directory, f"{prefix}.g{n}.trace.json")


def _profiling() -> bool:
    """Whether a torch profiler is attached (False where torch was never
    imported: then none can be)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _trace_annotation(label: str):
    """`torch.profiler.record_function(label)`, imported at span-open so
    that importing this module or building a Tracer needs neither torch
    nor a card (the validator and report CLIs are pure python)."""
    from torch.profiler import record_function
    return record_function(label)
