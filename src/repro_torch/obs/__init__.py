"""Observability layer (port of `repro.obs`): the same events, names and
files as the JAX package, shared by the quantize walk and the serve
runtime.

* `obs/trace.py`   — `Tracer`: nestable host spans + request lifecycle
  events, emitted as Chrome-trace/Perfetto JSON; `device=True` spans
  enter `torch.profiler.record_function`, so in a profiler trace a host
  span brackets the CUDA kernels it launched.
* `obs/metrics.py` — `MetricsRegistry`: counters / gauges / histograms
  with a JSONL event-stream sink and Prometheus text exposition.
* `obs/timeline.py` — per-request serve timelines (submit → admit →
  first_token → decode tokens → preempt/resume → retire) reconstructed
  from the tracer's request events, rid-dedup'd across crash-replay
  restarts.
* `obs/validate.py` — pure-python Chrome-trace schema checker
  (`python -m repro_torch.obs.validate [--timelines] FILES`).
* `obs/report.py`  — `python -m repro_torch.obs.report DIR` renders a
  run summary table from the sinks.

Instrumentation is zero-cost when disabled and adds no host sync:
disabled tracers and registries are shared null singletons whose hooks
return at once, and enabled ones only append host values — quantities
that live on the card stay there until the run's one end-of-run pull.
The one exception is asked for: a traced quantize walk waits for each
tap group's codes so that its `leaf_solve` span measures the solve.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, NULL_METRICS)
from repro_torch.obs.timeline import (RequestTimeline,  # noqa: F401
                                      dedup_events, reconstruct_timelines,
                                      request_events, validate_timeline)
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer,  # noqa: F401
                                   next_trace_path)
from repro_torch.obs.validate import (validate_trace,  # noqa: F401
                                      validate_trace_file)
