"""Per-request serve timelines reconstructed from tracer request events
(port of `repro.obs.timeline`).

The serve runtime emits instant events in the `request` category:

    submit       {rid, prompt_len, max_new_tokens, priority}
    admit        {rid, slot, resumed, prefill_len}
    first_token  {rid, token}
    token        {rid, i, token}          (one per decoded token)
    preempt      {rid, n_preempts}
    resume       {rid, slot}              (admit with resumed=True also
                                           counts as a resume marker)
    retire       {rid, reason, new_tokens}

`reconstruct_timelines(events)` turns a merged event stream — possibly
from several crash-replay restart generations — into one
`RequestTimeline` per rid.  Dedup rules (crash-replay semantics:
replayed requests re-emit their token stream bit-identically):

* `submit` / `first_token` / `retire` — keep-first by rid;
* `token` — keep-first by (rid, i): replays re-deliver the same prefix;
* `admit` / `preempt` / `resume` — kept as occurrences (a request may
  legitimately be admitted/preempted many times), except exact
  duplicates (same rid, kind, and args) from a replayed generation
  collapse to the earliest occurrence.

`validate_timeline` checks lifecycle completeness: a retired request
must have submit ≤ admit ≤ first_token ≤ retire and a token count
matching its retire record.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

_KEEP_FIRST = ("submit", "first_token", "retire")
_LIFECYCLE = ("submit", "admit", "first_token", "token",
              "preempt", "resume", "retire")


def request_events(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Filter a Chrome-trace event list down to `request`-category
    instants, sorted by timestamp (stable for ties)."""
    evs = [e for e in events
           if e.get("cat") == "request" and e.get("ph") == "i"]
    evs.sort(key=lambda e: e.get("ts", 0.0))
    return evs


def dedup_events(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Collapse crash-replay duplicates; see module docstring for rules."""
    out: List[Dict[str, Any]] = []
    seen_once: set = set()          # (kind, rid) for keep-first kinds
    seen_tok: set = set()           # (rid, i) for token events
    seen_exact: set = set()         # (kind, rid, frozen args) for the rest
    for e in request_events(events):
        kind = e.get("name")
        args = e.get("args", {})
        rid = args.get("rid")
        if kind in _KEEP_FIRST:
            k = (kind, rid)
            if k in seen_once:
                continue
            seen_once.add(k)
        elif kind == "token":
            k = (rid, args.get("i"))
            if k in seen_tok:
                continue
            seen_tok.add(k)
        else:
            k = (kind, rid, tuple(sorted(
                (a, v) for a, v in args.items() if a != "rid")))
            if k in seen_exact:
                continue
            seen_exact.add(k)
        out.append(e)
    return out


@dataclass
class RequestTimeline:
    """One request's lifecycle, reconstructed from the event stream."""
    rid: int
    t_submit: Optional[float] = None       # epoch µs
    t_first_token: Optional[float] = None
    t_retire: Optional[float] = None
    admits: List[float] = field(default_factory=list)
    preempts: List[float] = field(default_factory=list)
    resumes: List[float] = field(default_factory=list)
    tokens: List[Tuple[int, int]] = field(default_factory=list)  # (i, tok)
    finish_reason: str = ""
    new_tokens: int = 0
    prompt_len: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) / 1e6

    @property
    def wall_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_retire is None:
            return None
        return (self.t_retire - self.t_submit) / 1e6

    @property
    def complete(self) -> bool:
        return (self.t_submit is not None and bool(self.admits)
                and self.t_first_token is not None
                and self.t_retire is not None)


def reconstruct_timelines(
        events: Sequence[Dict[str, Any]]) -> Dict[int, RequestTimeline]:
    """Merged (+deduped) event stream → {rid: RequestTimeline}."""
    tls: Dict[int, RequestTimeline] = {}
    for e in dedup_events(events):
        kind = e.get("name")
        if kind not in _LIFECYCLE:
            continue
        args = e.get("args", {})
        rid = args.get("rid")
        ts = e.get("ts", 0.0)
        tl = tls.get(rid)
        if tl is None:
            tl = tls[rid] = RequestTimeline(rid=rid)
        if kind == "submit":
            tl.t_submit = ts
            tl.prompt_len = int(args.get("prompt_len", 0))
        elif kind == "admit":
            tl.admits.append(ts)
            if args.get("resumed"):
                tl.resumes.append(ts)
        elif kind == "first_token":
            tl.t_first_token = ts
        elif kind == "token":
            tl.tokens.append((int(args.get("i", -1)),
                              int(args.get("token", -1))))
        elif kind == "preempt":
            tl.preempts.append(ts)
        elif kind == "resume":
            tl.resumes.append(ts)
        elif kind == "retire":
            tl.t_retire = ts
            tl.finish_reason = str(args.get("reason", ""))
            tl.new_tokens = int(args.get("new_tokens", 0))
    for tl in tls.values():
        tl.tokens.sort(key=lambda it: it[0])
    return tls


def validate_timeline(tl: RequestTimeline) -> List[str]:
    """Lifecycle completeness/order checks; [] means clean."""
    probs: List[str] = []
    if tl.t_submit is None:
        probs.append(f"rid={tl.rid}: no submit event")
    if not tl.admits:
        probs.append(f"rid={tl.rid}: never admitted")
    if tl.t_retire is not None:
        if tl.t_first_token is None and tl.new_tokens > 0:
            probs.append(f"rid={tl.rid}: retired with tokens but no "
                         "first_token event")
        if (tl.t_submit is not None and tl.t_first_token is not None
                and not (tl.t_submit <= tl.t_first_token <= tl.t_retire)):
            probs.append(f"rid={tl.rid}: timestamps out of order "
                         f"(submit={tl.t_submit}, first={tl.t_first_token},"
                         f" retire={tl.t_retire})")
        if tl.tokens and len(tl.tokens) != tl.new_tokens:
            probs.append(f"rid={tl.rid}: {len(tl.tokens)} token events vs "
                         f"retire new_tokens={tl.new_tokens}")
        idxs = [i for i, _ in tl.tokens]
        if idxs and idxs != list(range(len(idxs))):
            probs.append(f"rid={tl.rid}: token indices not contiguous "
                         f"({idxs[:8]}...)")
    if len(tl.preempts) > 0 and len(tl.resumes) + 1 < len(tl.preempts):
        # a request preempted N times must have been resumed at least
        # N-1 times before it could be preempted again
        probs.append(f"rid={tl.rid}: {len(tl.preempts)} preempts but only "
                     f"{len(tl.resumes)} resumes")
    return probs
