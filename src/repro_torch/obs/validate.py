"""Pure-python Chrome-trace/Perfetto schema checker (port of
`repro.obs.validate`; no torch, no numpy).

CI runs this over every trace the smoke steps emit; it is deliberately
strict about the subset of the Trace Event Format this repo produces:

* top level is an object with a `traceEvents` list;
* every event has `name` (str), `ph` in {"X", "i", "B", "E", "M"},
  numeric `ts`, and integer `pid`/`tid`;
* "X" events additionally need a numeric non-negative `dur`;
* "i" events need scope `s` in {"g", "p", "t"};
* `args`, when present, must be a JSON object.

Returns a list of problem strings; [] means the trace is loadable by
chrome://tracing and Perfetto.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

_PHASES = ("X", "i", "B", "E", "M")
_SCOPES = ("g", "p", "t")


def validate_event(ev: Any, idx: int) -> List[str]:
    probs: List[str] = []
    where = f"traceEvents[{idx}]"
    if not isinstance(ev, dict):
        return [f"{where}: not an object"]
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        probs.append(f"{where}: missing/empty name")
    ph = ev.get("ph")
    if ph not in _PHASES:
        probs.append(f"{where}: bad phase {ph!r} (want one of {_PHASES})")
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        probs.append(f"{where}: ts must be numeric, got {type(ts).__name__}")
    for key in ("pid", "tid"):
        v = ev.get(key)
        if not isinstance(v, int) or isinstance(v, bool):
            probs.append(f"{where}: {key} must be an int, "
                         f"got {type(v).__name__}")
    if ph == "X":
        dur = ev.get("dur")
        if (not isinstance(dur, (int, float)) or isinstance(dur, bool)
                or dur < 0):
            probs.append(f"{where}: X event needs non-negative numeric dur")
    if ph == "i" and ev.get("s") not in _SCOPES:
        probs.append(f"{where}: i event scope s={ev.get('s')!r} "
                     f"not in {_SCOPES}")
    args = ev.get("args")
    if args is not None and not isinstance(args, dict):
        probs.append(f"{where}: args must be an object")
    return probs


def validate_trace(doc: Any) -> List[str]:
    """Validate a parsed trace document; [] means clean."""
    if not isinstance(doc, dict):
        return ["top level must be an object with a traceEvents list"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    probs: List[str] = []
    for i, ev in enumerate(evs):
        probs.extend(validate_event(ev, i))
    return probs


def validate_trace_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace ({e})"]
    return [f"{path}: {p}" for p in validate_trace(doc)]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Chrome-trace schema checker")
    ap.add_argument("paths", nargs="+", help="trace JSON files")
    ap.add_argument("--timelines", action="store_true",
                    help="additionally reconstruct per-request timelines "
                         "from the (merged, rid-dedup'd) request events "
                         "and fail on any incomplete/inconsistent one")
    ap.add_argument("--require-preempt", action="store_true",
                    help="with --timelines: fail unless at least one "
                         "request was preempted AND resumed (the CI "
                         "smoke's preemption-coverage guarantee)")
    args = ap.parse_args(argv)
    bad = 0
    merged: List[Dict[str, Any]] = []
    for path in args.paths:
        probs = validate_trace_file(path)
        for p in probs:
            print(p)
        if probs:
            bad += 1
        else:
            with open(path) as f:
                evs = json.load(f).get("traceEvents", [])
            merged.extend(evs)
            print(f"{path}: OK ({len(evs)} events)")
    if args.timelines and not bad:
        from repro_torch.obs.timeline import reconstruct_timelines, \
            validate_timeline
        tls = reconstruct_timelines(merged)
        preempted = 0
        for rid in sorted(tls):
            tl = tls[rid]
            probs = [f"rid {rid}: {p}" for p in validate_timeline(tl)]
            for p in probs:
                print(p)
            bad += bool(probs)
            if tl.preempts and tl.resumes:
                preempted += 1
        print(f"timelines: {len(tls)} request(s), "
              f"{preempted} preempted+resumed")
        if args.require_preempt and not preempted:
            print("timelines: no preempted+resumed request "
                  "(--require-preempt)")
            bad += 1
    return bad


if __name__ == "__main__":
    import sys
    sys.exit(main())
