"""Communication-reducing collectives (port of `repro.dist.collectives`).

* `all_reduce_gram` — the single (m, m) all-reduce that data-parallel
  COMQ calibration needs per tap (`psum_gram`).
* `compressed_all_reduce` — int8 error-feedback all-reduce
  (`compressed_psum`): each rank quantizes (grad + carried error) onto a
  shared absmax grid, the all-reduce moves int32 code sums instead of f32
  values, and the local quantization residual is carried into the next
  step's state, so compression error never accumulates. Nothing calls it
  before the trainer.

Plain torch over `torch.distributed`, as JAX's are plain `jnp` over
named axes: a process group stands for the axis.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

Tensor = torch.Tensor
PyTree = Any


def all_reduce_gram(x: Tensor, group=None) -> Tensor:
    """Local features (..., m) -> the Gram H = Σ XᵀX over the group's
    ranks, in f32, with one all-reduce."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    h = x2.T @ x2
    dist.all_reduce(h, group=group)
    return h


def init_error_state(tree: PyTree) -> PyTree:
    """Zero error-feedback residuals, one per gradient leaf (f32)."""
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        tree)


def compressed_all_reduce(tree: PyTree, error: PyTree, group=None,
                          bits: int = 8) -> Tuple[PyTree, PyTree]:
    """Mean-reduce `tree` over `group` with int `bits` compression and
    error feedback. Returns (mean_tree, new_error_tree).

    Per leaf: v = g + e is quantized onto a shared grid (scale = the
    all-reduced MAX of the local absmax over qmax), so the code sums are
    exact in int32; the mean is sum(codes)·scale / group size and the
    local residual v − q·scale is the new carried error. On one rank
    out + new_e == g up to f32 rounding: compression never loses mass,
    it only delays it."""
    qmax = float(2 ** (bits - 1) - 1)
    size = dist.get_world_size(group)

    def one(g: Tensor, e: Tensor):
        v = g.float() + e
        amax = torch.amax(torch.abs(v)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0] / qmax, min=1e-30)
        q = torch.clamp(torch.round(v / scale), -qmax, qmax)
        new_e = v - q * scale
        codes = q.to(torch.int32)
        dist.all_reduce(codes, group=group)
        return codes.float() * scale / size, new_e

    flat, spec = pytree.tree_flatten(tree)
    eflat = pytree.tree_leaves(error)
    outs, errs = zip(*(one(g, e) for g, e in zip(flat, eflat)))
    return (pytree.tree_unflatten(list(outs), spec),
            pytree.tree_unflatten(list(errs), spec))
