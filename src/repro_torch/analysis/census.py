"""Collective census of a call (the counterpart of `repro.analysis.hlo`'s
`collective_census`).

JAX counts the collective instructions of a compiled module. Eager
PyTorch issues each collective as a `c10d::*` op through the dispatcher,
on gloo and nccl alike, so the census runs the call under
`torch.profiler` (host activity only: ranks sharing one card record no
device events of each other's collectives) and counts the `c10d::*` ops
it recorded, by primitive. An op nested inside another collective counts
with its outer one only. `Census.within(label)` counts the collectives
issued under a `torch.profiler.record_function(label)` scope, such as the
decode step inside a whole serve run.

No HLO exists to parse and no torch program has an input/output alias
table, so `parse_hlo`, `parse_io_aliases` and the donation audit have no
counterpart here; `analysis.contracts` checks in-place updates directly.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

# primitives, in torch.distributed's names
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast", "reduce", "gather", "scatter", "send", "recv",
               "barrier")

_C10D = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier",
    "monitored_barrier_": "barrier",
}


def primitive_of(op: str) -> Optional[str]:
    """'c10d::allreduce_' (or 'allreduce_') -> 'all_reduce'; None for an
    op that is not a collective."""
    return _C10D.get(op.split("::")[-1].split(".")[0])


class Census:
    """Context manager: the collectives issued inside, by primitive.

        with Census() as c:
            fn()
        c.counts                  # {"all_reduce": 4}
        c.within("decode_step")   # those under record_function("decode_step")

    It reads the profiler's raw event records (name, thread, start and
    end), not its FunctionEvent tree, whose construction costs about a
    millisecond an op: nesting is interval containment on one thread."""

    def __init__(self):
        self._prof = None
        self._events = []       # (primitive, thread, start, end)
        self._spans = []        # (name, thread, start, end), non-aten

    def __enter__(self) -> "Census":
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self._spans = []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if not name.startswith("aten::"):
                self._spans.append((name, e.start_thread_id(), e.start_ns(),
                                    e.end_ns()))
        calls = [(primitive_of(n), t, a, b) for n, t, a, b in self._spans
                 if n.startswith("c10d") and primitive_of(n)]
        # a collective inside another (a coalesced or object collective's
        # own ops) counts with its outer one only
        self._events = [c for c in calls if not any(
            o is not c and o[1] == c[1] and o[2] <= c[2] and c[3] <= o[3]
            and (o[2], o[3]) != (c[2], c[3]) for o in calls)]
        return False

    def _count(self, label: Optional[str]) -> Dict[str, int]:
        scopes = [s for s in self._spans if s[0] == label]
        out: Dict[str, int] = {}
        for prim, t, a, b in self._events:
            if label is None or any(st == t and sa <= a and b <= sb
                                    for _, st, sa, sb in scopes):
                out[prim] = out.get(prim, 0) + 1
        return out

    @property
    def counts(self) -> Dict[str, int]:
        return self._count(None)

    def within(self, label: str) -> Dict[str, int]:
        return self._count(label)


def collective_census(fn, *args, **kw) -> Dict[str, int]:
    """Run `fn(*args, **kw)` once; the collectives it issued, by
    primitive (empty for a call that issues none)."""
    with Census() as c:
        fn(*args, **kw)
    return c.counts
