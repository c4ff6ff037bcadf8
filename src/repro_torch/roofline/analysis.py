"""Op-level cost model and roofline terms (port of `repro.roofline.analysis`).

JAX walks the optimized HLO of a compiled program. Eager PyTorch has no
program to walk, so `count_cost(fn, *args)` runs the call under a
`TorchDispatchMode` and costs every aten op that reaches the dispatcher,
with the JAX parser's write-once byte model:

  * every op's output bytes count once (a view writes nothing and counts
    nothing; an in-place op writes the view it updates, a scatter its
    update operand, as JAX's dynamic-update-slice counts its slice);
  * `mm`, `bmm`, `addmm`, `baddbmm` and the collectives also count their
    operand reads (weights and contraction inputs re-stream from HBM);
  * matmul flops come from `torch.utils.flop_counter`'s formulas
    (2·M·K·N), and each pointwise op counts one flop per output element;
  * collective bytes are counted by primitive from the `c10d::*` ops, at
    max(operand, output) bytes, as JAX counts shard bytes.

A hand-written kernel is one opaque launch: its wrapper (`kernels/ops.py`,
`FlashAttention.backward`) charges the kernel's cost function
(`roofline/kernels.py`) to every active count through `charged(...)` and
keeps the ops it runs itself out of the count, its plain version's on the
CPU included. So a call costs the same on CPU, CUDA and meta tensors.

The hardware is a `Hardware` record; `H100` holds the H100 SXM data
sheet's figures (dense, no sparsity): 3.35e12 B/s HBM3; 989e12 bf16,
67e12 f32 (CUDA cores) and 1979e12 int8 operations a second; NVLink at
450e9 B/s each way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.census import primitive_of


@dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bytes_per_s: float
    peak_flops: Mapping[str, float]      # input type -> operations a second
    link_bytes_per_s: float              # one link, one direction
    links: int = 1


H100 = Hardware("NVIDIA H100 SXM", hbm_bytes_per_s=3.35e12,
                peak_flops={"f32": 67e12, "bf16": 989e12, "int8": 1979e12},
                link_bytes_per_s=450e9)


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "CostTotals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes_accessed += other.bytes_accessed * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = \
                self.collective_bytes.get(k, 0.0) + v * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def roofline_terms(cost: CostTotals, hw: Hardware = H100, *,
                   kind: str = "bf16") -> Dict[str, float]:
    """Seconds per call by the three-term model (the costs are per
    device), flops at `kind`'s peak; the keys of JAX's `roofline_terms`."""
    compute_s = cost.flops / hw.peak_flops[kind]
    memory_s = cost.bytes_accessed / hw.hbm_bytes_per_s
    collective_s = cost.total_collective_bytes / (hw.link_bytes_per_s
                                                  * hw.links)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }


# ---------------------------------------------------------------------------
# the op-level count
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_READS_OPERANDS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
_NO_WRITE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided}
# in-place scatters: traffic is the update operand, not the whole buffer
_UPDATE_ARG = {"index_put_": "values", "_index_put_impl_": "values",
               "index_copy_": "source", "index_add_": "source",
               "scatter_": "src", "scatter_add_": "src",
               "scatter_reduce_": "src", "masked_scatter_": "source",
               "put_": "source"}


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(x)
                     if isinstance(t, torch.Tensor)))


def _collective_bytes(func, args, kwargs):
    """(operand bytes, output bytes) of a c10d op, by its schema's argument
    names: `input*` is read, `output*` written, `tensor(s)` both (the
    in-place collectives)."""
    in_b = out_b = 0.0
    for i, a in enumerate(func._schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name.startswith("output"):
            out_b += _nbytes(val)
        elif a.name.startswith("input"):
            in_b += _nbytes(val)
        elif a.name in ("tensors", "tensor"):
            in_b += _nbytes(val)
            out_b += _nbytes(val)
    return in_b, out_b


def op_cost(func, args, kwargs, out) -> CostTotals:
    """The write-once cost of one dispatched op."""
    c = CostTotals()
    if func.namespace == "c10d":
        prim = primitive_of(func.__name__.split(".")[0])
        if prim is None:
            return c
        in_b, out_b = _collective_bytes(func, args, kwargs)
        c.collective_bytes[prim] = max(in_b, out_b)
        c.bytes_accessed = in_b + out_b
        return c
    packet = func.overloadpacket
    if packet in flop_registry:
        c.flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
    elif torch.Tag.pointwise in func.tags:
        c.flops = float(sum(t.numel() for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor)))
    if packet in _NO_WRITE:
        return c
    returns = func._schema.returns
    alias = returns[0].alias_info if returns else None
    if alias is not None and not alias.is_write:
        return c                     # a view: no bytes move
    upd = _UPDATE_ARG.get(packet.__name__)
    names = [a.name for a in func._schema.arguments]
    if upd in names:
        i = names.index(upd)
        c.bytes_accessed = _nbytes(args[i] if i < len(args)
                                   else kwargs.get(upd))
    elif upd is not None and "index" in names:   # a scalar fill: the
        i = names.index("index")                 # written entries
        idx = args[i] if i < len(args) else kwargs["index"]
        c.bytes_accessed = float(idx.numel() * out.element_size())
    else:
        c.bytes_accessed = _nbytes(out)
    if packet in _READS_OPERANDS:
        c.bytes_accessed += _nbytes([a for a in args
                                     if isinstance(a, torch.Tensor)])
    return c


class _CostMode(TorchDispatchMode):
    def __init__(self, totals: CostTotals):
        super().__init__()
        self.totals = totals
        self.quiet = 0               # > 0 inside a charged kernel call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            self.totals.add(op_cost(func, args, kwargs, out))
        return out


_ACTIVE: List[_CostMode] = []        # the counts running now, outermost first


def counting() -> bool:
    """Whether a `count_cost` is running (kernel wrappers charge only then)."""
    return bool(_ACTIVE)


def count_cost(fn, *args, **kw) -> CostTotals:
    """The write-once cost of `fn(*args, **kw)`, run once."""
    totals = CostTotals()
    mode = _CostMode(totals)
    _ACTIVE.append(mode)
    try:
        with mode:
            fn(*args, **kw)
    finally:
        _ACTIVE.remove(mode)
    return totals


class charged:
    """Inside a kernel wrapper: `with charged(cost_fn, *args, **kw):`
    charges `cost_fn(*args, **kw)` (a `roofline.kernels.KernelCost`) to
    every running count and keeps the ops run inside out of them. When
    nothing counts the cost function is not called (a class, not a
    generator: the wrappers are on the decode step's hot path)."""
    __slots__ = ("modes",)

    def __init__(self, cost_fn, *args, **kw):
        self.modes = list(_ACTIVE)
        if not self.modes:
            return
        for m in self.modes:
            m.quiet += 1
        try:
            cost = cost_fn(*args, **kw)     # may read lengths on the host
        except BaseException:
            self.__exit__()
            raise
        for m in self.modes:
            m.totals.flops += cost.flops
            m.totals.bytes_accessed += cost.bytes

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for m in self.modes:
            m.quiet -= 1
        return False
