"""Declarative contracts on calls (port of `repro.analysis.contracts`).

A contract states what an entry point is allowed to do on the wire and in
memory, independent of its numerics:

* ``collectives=0``                 — the call issues no collective at
  all (the column-sharded solve's invariant);
* ``collectives={"all_reduce": 1}`` — exactly one all-reduce and no
  collective of any other primitive (the one-all-reduce-per-tap Gram);
* ``inplace=(1,)``                  — positional argument 1 (a tensor or a
  tree of tensors, such as the paged KV pool or the train state) is
  updated in place: after the call it still holds the same storages, an
  output of the argument's tree shape holds them too, and on the card the
  call's transient allocation stayed below a copy of the argument: its
  peak (`torch.cuda.max_memory_allocated`, reset around the call alone)
  above what was allocated before it and what it left allocated (a cuBLAS
  workspace a new thread's handle takes, say, outlives the call and is no
  copy). JAX audits `donated=` in the compiled module's alias table; a
  torch call has none, so the storages themselves are checked. Scalar
  (0-dim) leaves, such as the optimizer's step counter, are not state
  memory and may be replaced.

`check_call(con, fn, *args)` runs the call once under the collective
census (`analysis.census`) and returns violation strings (empty: clean);
`assert_contract` raises `ContractViolation` with all of them. The
`@contract(...)` decorator only attaches metadata (``__comq_contract__``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.census import Census

CollectiveSpec = Union[int, Mapping[str, int], None]


class ContractViolation(AssertionError):
    """A call broke its declared contract."""


@dataclass(frozen=True)
class Contract:
    """What an entry point is allowed to do.

    collectives: None = unconstrained; an int N = the total number of
      collectives issued must equal N; a mapping = per-primitive exact
      counts, every primitive *not* named required to be 0.
    inplace: positional argnums whose every tensor leaf must be updated
      in place.
    """
    name: str = ""
    collectives: CollectiveSpec = None
    inplace: Tuple[int, ...] = ()
    notes: str = ""


def contract(collectives: CollectiveSpec = None,
             inplace: Sequence[int] = (), notes: str = ""):
    """Attach a Contract to a callable as metadata."""
    def deco(fn):
        fn.__comq_contract__ = Contract(
            name=getattr(fn, "__name__", ""),
            collectives=(dict(collectives)
                         if isinstance(collectives, Mapping)
                         else collectives),
            inplace=tuple(sorted(int(a) for a in inplace)), notes=notes)
        return fn
    return deco


def contract_of(fn) -> Optional[Contract]:
    return getattr(fn, "__comq_contract__", None)


def check_collectives(found: Dict[str, int], spec: CollectiveSpec,
                      name: str = "") -> List[str]:
    """Violation strings for a census against a collectives spec."""
    if spec is None:
        return []
    label = f"[{name}] " if name else ""
    if isinstance(spec, Mapping):
        out = []
        for prim in sorted(set(found) | set(spec)):
            want, got = int(spec.get(prim, 0)), found.get(prim, 0)
            if got != want:
                out.append(f"{label}collective census: {prim} x{got}, "
                           f"contract wants x{want}")
        return out
    total = sum(found.values())
    if total != int(spec):
        detail = ", ".join(f"{k} x{v}" for k, v in sorted(found.items()))
        return [f"{label}collective census: {total} collective(s) "
                f"[{detail or 'none'}], contract wants {int(spec)}"]
    return []


def _storages(tree):
    """(treespec, the storage address of every non-scalar tensor leaf)."""
    leaves, spec = tree_flatten(tree)
    return spec, [t.untyped_storage().data_ptr() if t.device.type != "meta"
                  else None for t in leaves
                  if isinstance(t, torch.Tensor) and t.dim()]


def _outputs_like(out, spec):
    """Subtrees of `out` (itself, or an element of a tuple/list output)
    with the tree shape `spec`; none for a bare tensor argument."""
    if spec.is_leaf():
        return []
    cands = [out] + (list(out) if isinstance(out, (tuple, list)) else [])
    return [c for c in cands if tree_flatten(c)[1] == spec]


def check_inplace(before, args, out, label: str = "") -> List[str]:
    """`before`: {argnum: (treespec, storages)} taken before the call."""
    msgs = []
    for a, (spec, ptrs) in before.items():
        spec_now, now = _storages(args[a])
        if spec_now != spec or now != ptrs:
            moved = sum(x != y for x, y in zip(now, ptrs))
            msgs.append(f"{label}in-place audit: arg {a} no longer holds its "
                        f"storage ({moved}/{len(ptrs)} leaves replaced)")
        for i, sub in enumerate(_outputs_like(out, spec)):
            got = _storages(sub)[1]
            moved = sum(x != y for x, y in zip(got, ptrs))
            if moved:
                msgs.append(f"{label}in-place audit: the output shaped like "
                            f"arg {a} holds new storage for {moved}/"
                            f"{len(ptrs)} of its leaves (updated out of "
                            "place)")
    return msgs


def _arg_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _cuda_device(trees):
    for t in tree_flatten(trees)[0]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def check_call(con: Contract, fn, *args, **kw) -> List[str]:
    """Run `fn(*args, **kw)` once under the census and check `con`."""
    label = f"[{con.name}] " if con.name else ""
    before = {a: _storages(args[a]) for a in con.inplace}
    dev = _cuda_device([args[a] for a in con.inplace])
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with Census() as census:
        out = fn(*args, **kw)
    msgs = check_collectives(census.counts, con.collectives, con.name)
    msgs += check_inplace(before, args, out, label)
    if dev is not None:
        torch.cuda.synchronize(dev)
        kept = max(base, torch.cuda.memory_allocated(dev))
        grew = torch.cuda.max_memory_allocated(dev) - kept
        size = sum(_arg_bytes(args[a]) for a in con.inplace)
        if grew >= size:
            msgs.append(f"{label}in-place audit: the call's transient "
                        f"allocation peaked at {grew} bytes, a copy of its "
                        f"in-place argument(s) ({size} bytes) or more")
    return msgs


def assert_contract(con: Contract, fn, *args, **kw) -> None:
    viol = check_call(con, fn, *args, **kw)
    if viol:
        raise ContractViolation("\n".join(viol))
