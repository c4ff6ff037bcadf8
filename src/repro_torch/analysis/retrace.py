"""Signature budgets on entry points (port of `repro.analysis.retrace`).

JAX compiles a program per distinct (shape, dtype, static) signature of a
jitted entry point, so counting traces counts compiles. Eager PyTorch
compiles nothing, but the same count still says what a later CUDA-graph
capture or `torch.compile` of the entry point would have to hold: one
graph per distinct signature. `guard_fn(fn, name=..., max_signatures=N)`
wraps a callable and counts the distinct (shape, dtype, device, static)
signatures it sees; a repeat is free, as a jit cache hit is. Budgets:

* ``max_signatures=N``   — a ceiling on distinct signatures (the serve
  decode step declares 1: a fixed (max_slots, maxb) table; each prefill
  bucket declares 1);
* ``per_signature=True`` — any number of distinct signatures; noting a
  signature already noted is a violation (JAX's cache-thrash check,
  which the wrapper itself never triggers: it notes new ones only).

A violation warns in dev and raises `RetraceViolation` under pytest/CI
(`PYTEST_CURRENT_TEST` in the environment, or `COMQ_STRICT_RETRACE=1`;
`COMQ_STRICT_RETRACE=0` force-disables strictness), as in JAX. Every
guard registers under its name; `compile_count(name)` is its count of
signatures and `retrace_report()` feeds the CLI gate. Re-creating a guard
under an existing name (a fresh Runtime) starts a fresh record.
"""
from __future__ import annotations

import functools
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import torch
from torch.utils._pytree import tree_flatten


class RetraceViolation(RuntimeError):
    """An entry point exceeded its declared signature budget."""


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
