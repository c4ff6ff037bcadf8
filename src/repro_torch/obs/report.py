"""`python -m repro_torch.obs.report DIR` — run summary from obs sinks
(port of `repro.obs.report`; it reads either package's files).

Reads whatever a `--trace DIR` / `--metrics DIR` run left behind:

* `*.trace.json`   — Chrome-trace files (all generations of a
  crash-replay run merge); the serve `request` events reconstruct
  per-request timelines, span events aggregate per-name totals;
* `metrics.jsonl`  — the registry event stream (counters/gauges print
  as-is, histograms recompute p50/p99 from raw values).

Output is a plain table on stdout — no deps beyond the stdlib — so it
works in CI logs and over ssh.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Any, Dict, List

from repro_torch.obs.metrics import quantile as _quantile
from repro_torch.obs.timeline import reconstruct_timelines, validate_timeline


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        if v and abs(v) < 0.01:
            return f"{v:.2e}"
        return f"{v:.4g}"
    return str(v)


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(r[i]) for r in [header] + rows)
              for i in range(len(header))]
    def line(r):
        return "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), sep] + [line(r) for r in rows])


def load_events(run_dir: str) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*.trace.json"))):
        with open(path) as f:
            events.extend(json.load(f).get("traceEvents", []))
    return events


def span_summary(events: List[Dict[str, Any]]) -> str:
    agg: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "span":
            agg.setdefault(e["name"], []).append(e.get("dur", 0.0))
    if not agg:
        return ""
    rows = []
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        durs = agg[name]
        rows.append([name, str(len(durs)),
                     _fmt(sum(durs) / 1e6), _fmt(_quantile(durs, 0.5) / 1e6),
                     _fmt(max(durs) / 1e6)])
    return _table(rows, ["span", "count", "total_s", "p50_s", "max_s"])


def request_summary(events: List[Dict[str, Any]]) -> str:
    tls = reconstruct_timelines(events)
    if not tls:
        return ""
    rows = []
    problems: List[str] = []
    for rid in sorted(tls):
        tl = tls[rid]
        problems += validate_timeline(tl)
        rows.append([str(rid), str(tl.prompt_len), str(tl.new_tokens),
                     _fmt(tl.ttft_s if tl.ttft_s is not None
                          else float("nan")),
                     _fmt(tl.wall_s if tl.wall_s is not None
                          else float("nan")),
                     str(len(tl.preempts)), str(len(tl.resumes)),
                     tl.finish_reason or "-"])
    out = _table(rows, ["rid", "prompt", "tokens", "ttft_s", "wall_s",
                        "preempts", "resumes", "finish"])
    if problems:
        out += "\n\ntimeline problems:\n" + "\n".join(
            f"  {p}" for p in problems)
    return out


def metrics_summary(run_dir: str) -> str:
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return ""
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            rec = json.loads(ln)
            if rec.get("kind") == "histogram":
                vals = rec.get("values", [])
                rows.append([rec["name"], "histogram",
                             f"n={rec.get('count', len(vals))} "
                             f"p50={_fmt(_quantile(vals, 0.5))} "
                             f"p99={_fmt(_quantile(vals, 0.99))}"])
            else:
                rows.append([rec["name"], rec.get("kind", "?"),
                             _fmt(rec.get("value"))])
    if not rows:
        return ""
    return _table(rows, ["metric", "kind", "value"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render a run summary table from --trace/--metrics "
                    "sink directories")
    ap.add_argument("run_dir", help="directory holding *.trace.json "
                                    "and/or metrics.jsonl")
    args = ap.parse_args(argv)

    events = load_events(args.run_dir)
    sections = [("spans", span_summary(events)),
                ("requests", request_summary(events)),
                ("metrics", metrics_summary(args.run_dir))]
    printed = False
    for title, body in sections:
        if body:
            print(f"== {title} ==")
            print(body)
            print()
            printed = True
    if not printed:
        print(f"no obs artifacts found under {args.run_dir}")
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
