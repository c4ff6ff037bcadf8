"""Signature budgets on entry points, and the serving steps' CUDA graphs
(port of `repro.analysis.retrace`).

JAX compiles a program per distinct (shape, dtype, static) signature of a
jitted entry point, so counting traces counts compiles. The port has two
wrappers that count the same way:

* `guard_fn(fn, name=..., max_signatures=N)` counts the distinct (shape,
  dtype, device, static) signatures of an eager callable; a repeat is
  free, as a jit cache hit is.
* `guard_graph(fn, name=..., device=..., copy_argnums=...)` is JAX's
  `guard_jit`: a signature's first call captures `fn` as one CUDA graph
  and every later call replays it (on the CPU it runs `fn` eagerly; see
  its docstring). The runtime's decode step, prefill buckets and prefill
  writes, and the Engine's prefill and decode step run under it; a
  `GraphPool` lets one owner's graphs share one memory pool.

Budgets:

* ``max_signatures=N``   — a ceiling on distinct signatures (the serve
  decode step declares 1: a fixed (max_slots, maxb) table; each prefill
  bucket and each prefill write's cache length declares 1);
* ``per_signature=True`` — any number of distinct signatures; noting a
  signature already noted is a violation (JAX's cache-thrash check,
  which the wrappers themselves never trigger: they note new ones only).

A violation warns in dev and raises `RetraceViolation` under pytest/CI
(`PYTEST_CURRENT_TEST` in the environment, or `COMQ_STRICT_RETRACE=1`;
`COMQ_STRICT_RETRACE=0` force-disables strictness), as in JAX. Every
guard registers under its name; `compile_count(name)` is its count of
signatures (of captures, for a `guard_graph`) and `retrace_report()`
feeds the CLI gate. Re-creating a guard under an existing name (a fresh
Runtime) starts a fresh record.
"""
from __future__ import annotations

import functools
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class RetraceViolation(RuntimeError):
    """An entry point exceeded its declared signature budget."""


class GraphCaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph: the message names the
    op it failed at."""


def strict_mode() -> bool:
    env = os.environ.get("COMQ_STRICT_RETRACE")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "")
    return "PYTEST_CURRENT_TEST" in os.environ


@dataclass
class GuardRecord:
    name: str
    max_signatures: Optional[int] = None
    per_signature: bool = False
    traces: int = 0
    signatures: Set[Any] = field(default_factory=set)
    violations: List[str] = field(default_factory=list)

    def note_trace(self, sig) -> Optional[str]:
        """Record one new signature; returns a violation message or None."""
        self.traces += 1
        msg = None
        if self.per_signature and sig in self.signatures:
            msg = (f"retrace guard [{self.name}]: re-traced an already-"
                   f"seen signature (trace #{self.traces}) — the cache is "
                   "thrashing")
        self.signatures.add(sig)
        if (msg is None and self.max_signatures is not None
                and self.traces > self.max_signatures):
            msg = (f"retrace guard [{self.name}]: signature #{self.traces} "
                   f"exceeds the declared budget of {self.max_signatures}")
        if msg is not None:
            self.violations.append(msg)
        return msg


_GUARDS: Dict[str, GuardRecord] = {}


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    return repr(x)          # a static operand: identity by repr


def signature_of(args, kwargs):
    leaves, spec = tree_flatten((args, tuple(sorted(kwargs.items()))))
    return (str(spec), tuple(_leaf_key(leaf) for leaf in leaves))


def guard_fn(fn, *, name: str, max_signatures: Optional[int] = None,
             per_signature: bool = False):
    """`fn` with a signature budget registered under `name`."""
    rec = GuardRecord(name, max_signatures, per_signature)
    _GUARDS[name] = rec

    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        sig = signature_of(args, kwargs)
        if sig not in rec.signatures:
            msg = rec.note_trace(sig)
            if msg is not None:
                if strict_mode():
                    raise RetraceViolation(msg)
                warnings.warn(msg, stacklevel=2)
        return fn(*args, **kwargs)

    guarded.__comq_retrace_guard__ = rec
    return guarded


# ops a CUDA-graph capture refuses: each makes the host wait for the card
# (a value read on the host, or an output whose size is the data's)
_CAPTURE_REFUSED = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim"})
_MASK_INDEXED = frozenset({"aten::index", "aten::index_put",
                           "aten::index_put_", "aten::_index_put_impl_"})


class _OpTrail(TorchDispatchMode):
    """Keeps the last aten op dispatched, to name the op a capture failed
    at; with `refuse` it raises at an op a capture refuses (a boolean-mask
    index is a `nonzero` on the card): the CPU's stand-in for the card's
    refusal."""

    def __init__(self, name: str, refuse: bool):
        super().__init__()
        self.name, self.refuse, self.last = name, refuse, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func._schema.name
        self.last = op
        if self.refuse and (op in _CAPTURE_REFUSED or (
                op in _MASK_INDEXED and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in args[1] or ()))):
            raise GraphCaptureError(
                f"{self.name}: {op} makes the host wait for the card (a "
                "host read, or an output sized by the data), which a "
                "CUDA-graph capture refuses")
        return func(*args, **(kwargs or {}))


@dataclass
class _Captured:
    """One signature of a `guard_graph`: the call's arguments (static
    buffers at the copied positions, the held objects elsewhere), and on
    the card its graph, the graph's outputs, the kernel launches the
    capture recorded and the host seconds its warm-up and capture took."""
    args: list
    graph: Any = None
    out: Any = None
    launches: Dict[Any, int] = field(default_factory=dict)
    add_launches: Any = None
    seconds: float = 0.0


class GraphPool:
    """The memory pool of one owner's CUDA graphs (a Runtime's decode
    step, prefill buckets and prefill writes; an Engine's prefill and
    decode signatures), given to each of its `guard_graph`s as `pool=`.

    A graph captured into a shared pool may place its temporaries and its
    outputs in memory an earlier graph of the pool freed at the end of its
    own capture: another graph's temporaries, never another graph's
    outputs, which stay allocated. So the pool holds the largest
    temporary once, not once a graph (a bf16 prefill's cast of the
    unembed, 1.09 GB at qwen2-7b's width, would otherwise sit in every
    bucket's graph). The rule that makes sharing safe: one graph of the
    pool replays at a time, on one stream, and the caller reads a graph's
    outputs (enqueues what reads them, on that stream) before any other
    graph of the pool replays, since that replay may overwrite them.

    The pool's graphs are warmed up and captured on one side stream of
    its own: the caching allocator hands a freed block only to an
    allocation on the stream that freed it, so graphs captured on
    streams of their own would each keep their temporaries apart (at
    qwen2-7b's width, every prefill bucket its own ~2.5 GB).
    The handle and the stream are made at the first capture; a failed
    capture drops the handle, and the next capture starts a fresh pool."""

    def __init__(self):
        self.handle = None
        self.stream = None

    def bytes(self) -> Optional[int]:
        """Device bytes the pool holds: 0 before its first capture (and on
        the CPU, which captures nothing), None where the allocator's
        snapshot does not say which pool a segment belongs to."""
        return 0 if self.handle is None else _pool_bytes(tuple(self.handle))


def _copy_inputs(dst, args, copied) -> None:
    """Copy the call's inputs into the static buffers, without waiting. A
    copied position the call leaves out (an optional trailing input)
    has no buffer."""
    for i in copied:
        if i < len(args):
            dst[i].copy_(args[i], non_blocking=True)


def _capture(fn, name: str, args, copied, dev: torch.device,
             pool: GraphPool):
    """A new signature: its static buffers and, on the card, the warm-up
    (whose result is this call's) and the capture. Returns (captured, the
    call's result)."""
    static = [torch.empty(a.shape, dtype=a.dtype, device=dev)
              if i in copied else a for i, a in enumerate(args)]
    _copy_inputs(static, args, copied)
    if dev.type != "cuda":
        with _OpTrail(name, refuse=True):
            return _Captured(static), fn(*static)
    from repro_torch.kernels import ops
    cur = torch.cuda.current_stream(dev)
    if pool.stream is None:
        pool.stream = torch.cuda.Stream(dev)
    side = pool.stream
    side.wait_stream(cur)
    if pool.handle is None:
        pool.handle = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        # the warm-up: kernel builds, head-map tables and first-use
        # workspaces come into being here, never inside the capture, and
        # the step's in-place updates run once, for this call
        out = fn(*static)
        before = ops.launch_state()
        try:
            with torch.cuda.graph(graph, pool=pool.handle, stream=side):
                static_out = fn(*static)
        except Exception as e:
            _end_pool(dev, pool)
            raise GraphCaptureError(
                f"{name}: the CUDA-graph capture failed at "
                f"{_failing_op(fn, static, dev, side)}: "
                f"{type(e).__name__}: {e}") from e
        finally:
            # the capture ran the wrappers but launched nothing: take its
            # counts back; each replay adds them
            after = ops.launch_state()
            ops.add_launches({k: before[k] - n for k, n in after.items()})
    cur.wait_stream(side)
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(cur)
    delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
    return _Captured(static, graph, static_out, delta, ops.add_launches,
                     time.perf_counter() - t0), out


def _end_pool(dev: torch.device, pool: GraphPool) -> None:
    """After a failed capture: the capture ended before the allocator
    stopped recording into the pool; stop it, and let the next capture
    take a fresh pool."""
    try:
        torch._C._cuda_endAllocateToPool(
            torch.cuda.current_device() if dev.index is None else dev.index,
            pool.handle)
    except Exception:   # noqa: BLE001 - the next pool is fresh anyway
        pass
    pool.handle = None


def _failing_op(fn, static, dev: torch.device, stream) -> str:
    """The op a failed capture of `fn` stopped at: a second capture, into
    a pool of its own, under `_OpTrail` (the first one runs without it: a
    process's first dispatch mode imports ~850 modules, seconds that would
    fall on a serving step). A capture runs nothing, so the step's state
    is as the warm-up left it."""
    trail, pool = _OpTrail("", refuse=False), GraphPool()
    pool.handle = torch.cuda.graph_pool_handle()
    try:
        with trail, torch.cuda.graph(torch.cuda.CUDAGraph(),
                                     pool=pool.handle, stream=stream):
            fn(*static)
    except Exception:   # noqa: BLE001 - the failure being located
        _end_pool(dev, pool)
        return trail.last or "its first op"
    return "no op: a second capture succeeded"


def guard_graph(fn, *, name: str, device, copy_argnums=(),
                max_signatures: Optional[int] = None,
                per_signature: bool = False,
                pool: Optional[GraphPool] = None):
    """`fn` run as one CUDA graph per signature, with a signature budget
    registered under `name` (JAX's `guard_jit`: a compile is a capture
    here, and a donated buffer one the step updates in place).

    Call it with positional arguments. Those at `copy_argnums` are the
    step's inputs: every call copies them into static buffers on `device`
    (without waiting: from pinned host memory the copy is asynchronous,
    and the caller must not rewrite its buffer before the stream has read
    it); a call may leave out trailing ones (an optional input). Every
    other argument is held: the graph reads it where it lay at capture,
    so every call must pass the very same objects (the params, a pool or
    cache the step updates in place, a device scalar it advances);
    another object is another signature. The signature is the inputs'
    (shape, dtype) and the held arguments' identity.

    On a CUDA `device` a signature's first call warms `fn` up on a side
    stream (its result is that call's), then captures it into the memory
    pool this guard's graphs share, `pool`'s where one is given (the
    rule its docstring states is then the caller's to keep), else one of
    the guard's own; every later call copies its inputs,
    replays the graph and returns the graph's own outputs (read them
    before the next call overwrites them), and adds the kernel launches
    the capture recorded to `kernels.ops`'s counters. A capture that fails
    raises `GraphCaptureError` naming the op it failed at; nothing runs
    `fn` eagerly in place of a graph, and nothing turns capture off. On
    the CPU, which has no graphs, every call runs `fn` on the static
    buffers, and a signature's first call refuses the ops a capture
    refuses, as the card would."""
    rec = GuardRecord(name, max_signatures, per_signature)
    _GUARDS[name] = rec
    dev = torch.device(device)
    copied = frozenset(copy_argnums)
    graphs: Dict[Any, _Captured] = {}
    pool = GraphPool() if pool is None else pool

    @functools.wraps(fn)
    def guarded(*args):
        key = tuple((tuple(a.shape), a.dtype) if i in copied else id(a)
                    for i, a in enumerate(args))
        cap = graphs.get(key)
        if cap is None:
            msg = rec.note_trace(key)
            if msg is not None:
                if strict_mode():
                    raise RetraceViolation(msg)
                warnings.warn(msg, stacklevel=2)
            try:
                cap, out = _capture(fn, name, args, copied, dev, pool)
            except GraphCaptureError:
                rec.traces -= 1          # nothing was captured
                rec.signatures.discard(key)
                raise
            graphs[key] = cap
            return out
        _copy_inputs(cap.args, args, copied)
        if cap.graph is None:
            return fn(*cap.args)
        cap.graph.replay()
        if cap.launches:
            cap.add_launches(cap.launches)
        return cap.out

    guarded.__comq_retrace_guard__ = rec
    guarded.__comq_graphs__ = graphs
    guarded.__comq_pool__ = pool
    return guarded


def capture_seconds(guarded) -> float:
    """Host seconds a `guard_graph`'s warm-ups and captures took (each
    ends in the capture's own synchronization)."""
    return sum(c.seconds for c in guarded.__comq_graphs__.values())


def graph_pool_bytes(guarded) -> Optional[int]:
    """Device bytes of the memory pool a `guard_graph`'s graphs share
    (with a `GraphPool`, every graph of that pool): 0 with no graph (the
    CPU), None where the allocator's snapshot does not say which pool a
    segment belongs to."""
    caps = [c for c in guarded.__comq_graphs__.values()
            if c.graph is not None]
    return _pool_bytes(tuple(caps[0].graph.pool())) if caps else 0


def _pool_bytes(pool_id) -> Optional[int]:
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" in seg:
            seen = True
            if tuple(seg["segment_pool_id"]) == pool_id:
                total += seg["total_size"]
    return total if seen else None


def compile_count(name: str) -> int:
    """Signatures recorded by the most recent guard under `name`."""
    rec = _GUARDS.get(name)
    return 0 if rec is None else rec.traces


def guard_violations(name: Optional[str] = None) -> List[str]:
    if name is not None:
        rec = _GUARDS.get(name)
        return list(rec.violations) if rec else []
    return [v for rec in _GUARDS.values() for v in rec.violations]


def retrace_report() -> Dict[str, Dict[str, Any]]:
    return {
        n: {"traces": r.traces, "max_signatures": r.max_signatures,
            "per_signature": r.per_signature,
            "distinct_signatures": len(r.signatures),
            "violations": list(r.violations)}
        for n, r in sorted(_GUARDS.items())
    }


def reset_guards(name: Optional[str] = None) -> None:
    """Drop guard records (all, or one name). Live guarded callables keep
    counting into their own (now unregistered) records."""
    if name is None:
        _GUARDS.clear()
    else:
        _GUARDS.pop(name, None)
