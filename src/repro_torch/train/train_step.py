"""Training step: microbatched gradient accumulation + AdamW (port of
`repro.train.train_step`).

One bf16 working copy of the f32 master params a step: detached bf16
leaves that require grad, so the backward's cotangents accumulate in bf16
as in the JAX package's graph; their gradients are accumulated in f32 over
`RunConfig.microbatches` (a Python loop where JAX scans), averaged,
clipped by global norm and applied by `adamw_update` to the f32 master.
With `RunConfig.grad_compression="int8_ef"` the mean gradient is
all-reduced through `dist.compressed_all_reduce` over a process group
(int8 codes on a shared absmax grid, one grid for the per-layer leaves
of each JAX leaf, the local residual carried in the train state as
`grad_err`), where the JAX package needs a named mesh axis. Remat is the
model's `BuildPlan.remat`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.model import lm_loss
from repro_torch.optim import (AdamWConfig, adamw_init, global_norm,
                               warmup_cosine)
from repro_torch.optim.adamw import adamw_update_

PyTree = Any
Tensor = torch.Tensor


def stacked_grids(tree: PyTree) -> list:
    """One key per leaf of a params-shaped tree: its path without list
    indices. The per-layer leaves of one JAX leaf (the JAX package stacks
    "layers" along a leading axis; convert.py splits it into a list) get
    one key, so the int8_ef all-reduce gives them that leaf's one scale."""
    return [tuple(k for k in path if not isinstance(k, pytree.SequenceKey))
            for path, _ in pytree.tree_flatten_with_path(tree)[0]]


def init_train_state(params: PyTree, adamw_cfg: AdamWConfig,
                     run_cfg=None) -> Dict:
    """A new train state holding its own copy of `params`: the step updates
    the state in place, and the caller's tensors never change, as JAX's
    arrays do not."""
    params = pytree.tree_map(lambda p: p.detach().clone(), params)
    state = {"params": params, "opt": adamw_init(params, adamw_cfg)}
    if run_cfg is not None and run_cfg.grad_compression == "int8_ef":
        from repro_torch.dist.collectives import init_error_state
        state["grad_err"] = init_error_state(params)
    return state


def _loss_and_grads(cfg, plan, nm: int, params: PyTree,
                    batch: Dict[str, Tensor]) -> Tuple[Tensor, PyTree]:
    """The mean loss over `nm` microbatches and the f32 mean gradient with
    respect to one bf16 working copy of the f32 leaves (before any
    all-reduce or clipping)."""
    flat, spec = pytree.tree_flatten(params)
    cast = [(p.detach().to(torch.bfloat16) if p.dtype == torch.float32
             else p.detach()).requires_grad_(True) for p in flat]
    tree = pytree.tree_unflatten(cast, spec)
    mbs = {k: (v.reshape(nm, v.shape[0] // nm, *v.shape[1:])
               if v.dim() else v) for k, v in batch.items()}
    gacc, losses = None, []
    for i in range(nm):
        mb = {k: (v[i] if v.dim() else v) for k, v in mbs.items()}
        loss, _ = lm_loss(tree, cfg, plan, mb)
        grads = torch.autograd.grad(loss, cast)
        if gacc is None:
            gacc = [g.float() for g in grads]
        else:
            for a, g in zip(gacc, grads):
                a.add_(g.float())
        del grads
        losses.append(loss.detach())
    if nm > 1:
        for a in gacc:
            a.div_(nm)
    loss = torch.mean(torch.stack(losses)) if nm > 1 else losses[0]
    return loss, pytree.tree_unflatten(gacc, spec)


def make_train_step(cfg, plan, run_cfg, adamw_cfg: AdamWConfig,
                    group=None):
    """Returns `train_step(state, batch) -> (new_state, metrics)`.

    `group`: the process group the int8_ef all-reduce runs over, or
    "world" for the default group of whatever world is up when the step
    runs; required for int8_ef, as JAX's step requires `axis_name=`.

    The step owns its input state, as JAX's `donate_argnums=(0,)` makes
    it: the new params, moments and error state are written into its
    tensors, so the update needs no second copy of the state. A caller
    that keeps a state must pass a copy (`init_train_state` takes one of
    the params)."""
    nm = max(1, run_cfg.microbatches)
    compress = run_cfg.grad_compression == "int8_ef"
    if run_cfg.grad_compression not in ("none", "int8_ef"):
        raise ValueError(
            f"unknown grad_compression {run_cfg.grad_compression!r}")
    if compress and group is None:
        raise ValueError(
            "grad_compression='int8_ef' all-reduces int8 codes over a "
            "process group: start a world (repro_torch.dist.init_world) and "
            "pass group=")

    pg = None if group == "world" else group    # torch.distributed's default

    def train_step(state: Dict, batch: Dict[str, Tensor]
                   ) -> Tuple[Dict, Dict]:
        params, opt = state["params"], state["opt"]
        lr = warmup_cosine(opt["step"], base_lr=run_cfg.learning_rate,
                           warmup_steps=run_cfg.warmup_steps,
                           total_steps=run_cfg.total_steps)
        loss, grads = _loss_and_grads(cfg, plan, nm, params, batch)
        new_err = None
        if compress:
            # int8-EF all-reduce of the local gradient mean; the carried
            # residual rides in the state so no mass is ever lost
            import torch.distributed as dist

            from repro_torch.dist.collectives import compressed_all_reduce
            grads, new_err = compressed_all_reduce(
                grads, state["grad_err"], pg, grids=stacked_grids(grads))
            for old, new in zip(pytree.tree_leaves(state["grad_err"]),
                                pytree.tree_leaves(new_err)):
                old.copy_(new)
            new_err = state["grad_err"]
            loss = loss.clone()
            dist.all_reduce(loss, group=pg)
            loss = loss / dist.get_world_size(pg)
        # clip_by_global_norm, applied to the step's own gradient tree
        gnorm = global_norm(grads)
        factor = torch.clamp(run_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for g in pytree.tree_leaves(grads):
            g.mul_(factor)
        new_params, new_opt = adamw_update_(grads, opt, params, adamw_cfg, lr)
        del grads
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": new_opt["step"]}
        new_state = {"params": new_params, "opt": new_opt}
        if compress:
            new_state["grad_err"] = new_err
        return new_state, metrics

    return train_step
