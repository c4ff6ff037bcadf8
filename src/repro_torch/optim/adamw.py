"""AdamW with optional 8-bit (blockwise-quantized) moments (port of
`repro.optim.adamw`; plain PyTorch, the same state tree and key names, so
`CheckpointManager` step directories read both ways).

The 8-bit moment state (per-block absmax scales, block=256) cuts optimizer
memory from 8 to ~2.3 bytes/param. Rounding is deterministic (round half
to even, as `jnp.round`); the update math runs in f32 after decoding.

The signed first moment carries *error feedback*: the int8 rounding
residual (≤ scale/2 per element) is re-quantized to 2-bit codes on the
same block scale and stored packed 4-per-byte next to the int8 codes
("ef"), and decoding adds it back, so the EMA m ← β₁·decode(m) + (1−β₁)·g
runs on a value within scale/6 of the exact f32 moment and the int8 run
does not walk off the f32 one. The non-negative second moment keeps the
power-law codec ((v/absmax)^(1/4) on 255 levels), EF-free.

The JAX package chains the leaf updates with `optimization_barrier` only
to bound live temporaries; the port updates one leaf at a time already
(`kernels.ops.adamw_update_leaf`: the fused kernel on the card, its plain
version on the CPU; the codec lives beside them in `kernels/adamw.py`),
so the leaves are written in order and no token is computed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops
# the moment codec lives beside the fused update's kernel, which decodes
# and encodes it in place
from repro_torch.kernels.adamw import encode_m, encode_v

Tensor = torch.Tensor
PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"      # float32 | int8


def _moment_init(p: Tensor, dtype: str, signed: bool = True):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if dtype != "int8":
        return z
    return encode_m(z) if signed else encode_v(z)


def _is_enc(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


# ---------------------------------------------------------------------------


def adamw_init(params: PyTree, cfg: AdamWConfig) -> Dict[str, Any]:
    step_dev = pytree.tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=step_dev),
        "m": pytree.tree_map(
            lambda p: _moment_init(p, cfg.moment_dtype, True), params),
        "v": pytree.tree_map(
            lambda p: _moment_init(p, cfg.moment_dtype, False), params),
    }


def bias_corrections(step: Tensor, cfg: AdamWConfig, lr):
    """(lr, c1, c2) for the update that makes the counter `step`: 0-d f32
    tensors on its device, 1 - b^t computed there (a CUDA graph of the
    step reads the counter anew at every replay)."""
    t = step.to(torch.float32)
    dev = t.device
    c1 = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32,
                                    device=dev), t)
    c2 = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32,
                                    device=dev), t)
    return torch.as_tensor(lr, dtype=torch.float32, device=dev), c1, c2


def _update(grads: PyTree, state: Dict[str, Any], params: PyTree,
            cfg: AdamWConfig, lr, inplace: bool, factor=None
            ) -> Tuple[PyTree, Dict[str, Any]]:
    m_tree, v_tree = state["m"], state["v"]
    if inplace:
        step = state["step"]
        step.add_(1)
    else:
        step = state["step"] + 1
        params, m_tree, v_tree = pytree.tree_map(torch.clone,
                                                 (params, m_tree, v_tree))
    lr, c1, c2 = bias_corrections(step, cfg, lr)
    flat_p = pytree.tree_leaves(params)
    flat_g = pytree.tree_leaves(grads)
    flat_m = pytree.tree_leaves(m_tree, is_leaf=_is_enc)
    flat_v = pytree.tree_leaves(v_tree, is_leaf=_is_enc)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        ops.adamw_update_leaf(p, g, m, v, lr=lr, c1=c1, c2=c2, cfg=cfg,
                              factor=factor)
    return params, {"step": step, "m": m_tree, "v": v_tree}


def adamw_update(grads: PyTree, state: Dict[str, Any], params: PyTree,
                 cfg: AdamWConfig, lr) -> Tuple[PyTree, Dict[str, Any]]:
    """Returns (new_params, new_state). Master params stay f32; the inputs
    are left as they were, as JAX's arrays are (the update runs on copies)."""
    return _update(grads, state, params, cfg, lr, inplace=False)


def adamw_update_(grads: PyTree, state: Dict[str, Any], params: PyTree,
                  cfg: AdamWConfig, lr, factor=None
                  ) -> Tuple[PyTree, Dict[str, Any]]:
    """`adamw_update` for a caller that owns `state` and `params` (the
    train step, as JAX's `donate_argnums=(0,)` gives its jitted step): the
    step counter advances in place, and each leaf's update
    (`ops.adamw_update_leaf`: on the card one kernel launch, which reads
    and writes the leaf once; on the CPU the plain version, a slab of at
    most CHUNK entries at a time) writes the new param and moments into
    its tensors, so the update holds no second copy of the state. Returns
    the same trees."""
    return _update(grads, state, params, cfg, lr, inplace=True,
                   factor=factor)


def global_norm(tree: PyTree) -> Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, Tensor]:
    norm = global_norm(tree)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * factor, tree), norm
