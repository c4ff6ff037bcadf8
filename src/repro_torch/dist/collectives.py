"""Communication-reducing collectives (port of `repro.dist.collectives`).

* `all_reduce_gram` — the single (m, m) all-reduce that data-parallel
  COMQ calibration needs per tap (`psum_gram`).
* `compressed_all_reduce` — int8 error-feedback all-reduce
  (`compressed_psum`): each rank quantizes (grad + carried error) onto a
  shared absmax grid, the all-reduce moves int32 code sums instead of f32
  values, and the local quantization residual is carried into the next
  step's state, so compression error never accumulates. The train step
  calls it under `grad_compression="int8_ef"`.

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
                          bits: int = 8, grids=None
                          ) -> Tuple[PyTree, PyTree]:
    """Mean-reduce `tree` over `group` with int `bits` compression and
    error feedback. Returns (mean_tree, new_error_tree).

    Per grid: v = g + e is quantized onto a shared grid (scale = the
    all-reduced MAX of the local absmax over qmax), so the code sums are
    exact in int32; the mean is sum(codes)·scale / group size and the
    local residual v − q·scale is the new carried error. On one rank
    out + new_e == g up to f32 rounding: compression never loses mass,
    it only delays it.

    A grid is a leaf, unless `grids` (one key per leaf, in flattening
    order) gives several leaves one key: they then share one scale, the
    absmax over all of them, as the slices of one stacked array share its
    scale in the JAX package (`train_step.stacked_grids`)."""
    qmax = float(2 ** (bits - 1) - 1)
    size = dist.get_world_size(group)
    flat, spec = pytree.tree_flatten(tree)
    eflat = pytree.tree_leaves(error)
    keys = list(range(len(flat))) if grids is None else list(grids)
    index = {k: i for i, k in enumerate(dict.fromkeys(keys))}
    # v is formed twice, for the absmax and for the codes, so that one
    # leaf's v is live at a time
    leaf_max = torch.stack([torch.amax(torch.abs(g.float() + e))
                            for g, e in zip(flat, eflat)])
    ids = torch.tensor([index[k] for k in keys], device=leaf_max.device)
    amax = torch.zeros(len(index), device=leaf_max.device).scatter_reduce_(
        0, ids, leaf_max, "amax")
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scales = torch.clamp(amax / qmax, min=1e-30)
    outs, errs = [], []
    for g, e, i in zip(flat, eflat, ids.tolist()):
        v = g.float() + e
        scale = scales[i]
        q = torch.clamp(torch.round(v / scale), -qmax, qmax)
        errs.append(v - q * scale)
        codes = q.to(torch.int32)
        dist.all_reduce(codes, group=group)
        outs.append(codes.float() * scale / size)
    return (pytree.tree_unflatten(outs, spec),
            pytree.tree_unflatten(errs, spec))
