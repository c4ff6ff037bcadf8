"""Metrics registry: counters, gauges, histograms + two sinks (port of
`repro.obs.metrics`, the same semantics and file formats).

`MetricsRegistry` is a name → instrument map with get-or-create
semantics (`registry.counter("serve.preemptions")`).  Instruments are
deliberately dumb host-side accumulators — a counter is one float add,
a histogram is one list append — so they are legal inside the lint-
enforced hot zones as long as the *values* handed to them are already
host scalars (the sync-free accumulation rule: device quantities stay
on the device and are observed once at the end of the run).

Histograms keep the raw observations.  `quantile(q)` reproduces
`numpy.percentile(values, q*100)` bit for bit, so code that computed
`np.percentile(itls, 99)` can switch to `hist.quantile(0.99)` and keep
its numbers; bucketing only happens at Prometheus export time.

Sinks:
* `dump_jsonl(path)`   — one JSON object per instrument (event stream
  consumed by `repro_torch.obs.report` and test assertions);
* `dump_prometheus(path)` — text exposition format (`# TYPE` lines,
  `_bucket{le=...}` / `_sum` / `_count` for histograms).

`NULL_METRICS` is the shared disabled registry: every instrument it
hands out is a no-op singleton, so `metrics or NULL_METRICS` makes all
call sites unconditionally safe and free when observability is off.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# default Prometheus bucket boundaries (seconds-flavoured; export-only)
_DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def add(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Raw-value histogram: exact quantiles, buckets only at export."""
    __slots__ = ("name", "values", "buckets")
    kind = "histogram"

    def __init__(self, name: str,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.values: List[float] = []
        self.buckets = tuple(buckets)

    def observe(self, v: float) -> None:
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def quantile(self, q: float) -> float:
        """`numpy.percentile(values, q*100)` (numpy's default, linear
        method), bit for bit; nan when empty."""
        return quantile(self.values, q)


def quantile(values: Sequence[float], q: float) -> float:
    """`numpy.percentile(values, q*100)` with numpy's default (linear)
    method, reproduced operation for operation in float64 so the result
    is the same bits: numpy divides the percentile by 100, places it at
    the virtual index (n − 1)·q, and interpolates from whichever
    neighbour is nearer (`numpy.lib._function_base_impl._lerp`). The JAX
    package's `a·(1 − t) + b·t` differs from numpy in the last bit for
    about one quantile in six."""
    if not values:
        return float("nan")
    xs = sorted(float(v) for v in values)
    n = len(xs)
    virtual = (n - 1) * ((q * 100.0) / 100.0)
    if virtual >= n - 1:
        return xs[-1]
    if virtual < 0:
        return xs[0]
    lo = math.floor(virtual)
    t = virtual - lo
    a, b = xs[lo], xs[lo + 1]
    d = b - a
    return b - d * (1.0 - t) if t >= 0.5 else a + d * t


class _NullInstrument:
    """One object plays disabled counter, gauge, and histogram."""
    __slots__ = ()
    name = "null"
    value = 0.0
    values: List[float] = []
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        return None

    def set(self, v: float) -> None:
        return None

    def add(self, n: float = 1.0) -> None:
        return None

    def observe(self, v: float) -> None:
        return None

    def quantile(self, q: float) -> float:
        return float("nan")


_NULL_INSTRUMENT = _NullInstrument()


class _NullMetrics:
    __slots__ = ()
    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=None) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def dump_jsonl(self, path: str) -> None:
        return None

    def dump_prometheus(self, path: str) -> None:
        return None


NULL_METRICS = _NullMetrics()


class MetricsRegistry:
    """Get-or-create instrument registry; thread-safe at creation."""
    enabled = True

    def __init__(self, run: str = "run"):
        self.run = run
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = factory()
                    self._instruments[name] = inst
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(
            name, lambda: Histogram(name, buckets or _DEFAULT_BUCKETS))

    # -- introspection -------------------------------------------------
    def instruments(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._instruments)

    def snapshot(self) -> Dict[str, Any]:
        """Flat JSON-able view: counters/gauges → value, histograms →
        {count, sum, p50, p99}.  Used by `ft.Heartbeat` snapshots."""
        out: Dict[str, Any] = {}
        for name, inst in sorted(self.instruments().items()):
            if inst.kind == "histogram":
                out[name] = {"count": inst.count, "sum": inst.sum,
                             "p50": inst.quantile(0.5),
                             "p99": inst.quantile(0.99)}
            else:
                out[name] = inst.value
        return out

    # -- sinks ---------------------------------------------------------
    def dump_jsonl(self, path: str) -> None:
        """One record per instrument; histograms carry raw values so the
        report CLI can recompute any quantile."""
        _ensure_dir(path)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for name, inst in sorted(self.instruments().items()):
                rec: Dict[str, Any] = {"name": name, "kind": inst.kind,
                                       "run": self.run}
                if inst.kind == "histogram":
                    rec["count"] = inst.count
                    rec["sum"] = inst.sum
                    rec["values"] = [float(v) for v in inst.values]
                else:
                    rec["value"] = inst.value
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def dump_prometheus(self, path: str) -> None:
        _ensure_dir(path)
        lines: List[str] = []
        for name, inst in sorted(self.instruments().items()):
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {inst.kind}")
            if inst.kind == "histogram":
                acc = 0
                for le in inst.buckets:
                    acc = sum(1 for v in inst.values if v <= le)
                    lines.append(f'{pname}_bucket{{le="{le}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {inst.count}')
                lines.append(f"{pname}_sum {inst.sum}")
                lines.append(f"{pname}_count {inst.count}")
            else:
                lines.append(f"{pname} {inst.value}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def _prom_name(name: str) -> str:
    """`serve.itl_seconds` → `serve_itl_seconds` (Prometheus charset)."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
