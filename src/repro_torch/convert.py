"""Convert JAX-package parameter trees (as numpy arrays, e.g. from
`jax.device_get`) into the port's layout, so both packages compute on the
same weights.

* `params_from_numpy`: `{"embed", "unembed", "final_norm", "layers"}` with
  "layers" a tree of (L, ...) stacks -> "layers" a per-layer list of dicts
  with the same leaf names and per-layer shapes; a VLM's "groups" (self
  (G, spg, ...) and cross (G, ...) stacks) -> per-group lists of
  per-layer dicts and a per-group list of cross-layer dicts.
* `qparams_from_numpy`: additionally converts a `quantize_model` output's
  "__qlayers__" QTensor side table (keys "0", "1", ..., or a VLM's
  "self_{g}_{s}" and "cross_{g}").

* `train_state_from_numpy`: a JAX train state ({"params", "opt": {"step",
  "m", "v"}[, "grad_err"]}, f32 or int8 moments) -> the port's, every
  tree's "layers" unstacked as `params_from_numpy` does.
* `train_state_to_numpy`: the reverse, the port's train state as numpy in
  the JAX layout ("layers" stacked along a leading L axis): what the
  port's Trainer checkpoints, so that a `CheckpointManager` step directory
  is the same file whichever package wrote it.

Every conversion is shape-agnostic, so a tensor-parallel plan's padded
trees (JAX's `init_params(key, cfg, BuildPlan(tp=k))`: heads, experts and
vocabulary padded) and their train states carry across as they are, and
the port's `BuildPlan(tp=k)` computes on them (tests/test_torch_padded.py).
A JAX `QT` leaf (a fake-quantized tree, e.g. the dry run's serving
layout; duck-typed by its codes / scale / z_lo / shape / bits / cpb)
becomes the port's `QT`, split per layer as the dense leaves are (the
codes, scales and zero-points along their leading layer dim, the
logical shape without it).

Neither imports JAX: the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _is_jax_qt(node) -> bool:
    return all(hasattr(node, a) for a in ("codes", "scale", "z_lo", "shape",
                                          "bits", "cpb"))


def _tree(node, dev):
    if isinstance(node, dict):
        return {k: _tree(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(v, dev) for v in node]
    if isinstance(node, (np.ndarray, np.generic)):
        return _tensor(node, dev)
    if _is_jax_qt(node):
        from repro_torch.core.apply import QT
        return QT(_tensor(node.codes, dev), _tensor(node.scale, dev),
                  _tensor(node.z_lo, dev), tuple(node.shape), node.bits,
                  cpb=node.cpb)
    return node


class _QTLayer:
    """Layer i of a stacked JAX QT leaf (its arrays sliced, the logical
    shape without the layer dim): what `_tree` converts."""

    def __init__(self, qt, i: int):
        self.codes, self.scale, self.z_lo = (qt.codes[i], qt.scale[i],
                                             qt.z_lo[i])
        self.shape, self.bits, self.cpb = tuple(qt.shape)[1:], qt.bits, qt.cpb


def _layer_slice(node, i: int):
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    if _is_jax_qt(node):
        return _QTLayer(node, i)
    return node[i]


def _n_stacked(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if _is_jax_qt(leaf):
        leaf = leaf.codes
    return int(leaf.shape[0])


def _unstack(stacked, dev):
    """A tree of (L, ...) stacks -> a list of L per-layer trees."""
    return [_tree(_layer_slice(stacked, i), dev)
            for i in range(_n_stacked(stacked))]


def params_from_numpy(tree, device: DeviceLike = None):
    """JAX params (numpy) -> the port's params."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items()
           if k not in ("layers", "groups", "__qlayers__")}
    if "layers" in tree:
        out["layers"] = _unstack(tree["layers"], dev)
    if "groups" in tree:
        self_p = tree["groups"]["self"]
        out["groups"] = {
            "self": [_unstack(_layer_slice(self_p, g), dev)
                     for g in range(_n_stacked(self_p))],
            "cross": _unstack(tree["groups"]["cross"], dev)}
    return out


def qparams_from_numpy(tree, device: DeviceLike = None):
    """JAX `quantize_model` output (numpy) -> the port's qparams: the dense
    params plus the "__qlayers__" table with QTensor dicts whose codes,
    scales and zero-points are torch tensors."""
    dev = resolve_device(device)
    out = params_from_numpy(tree, dev)
    if "__qlayers__" in tree:
        out["__qlayers__"] = {str(k): _tree(v, dev)
                              for k, v in tree["__qlayers__"].items()}
    return out


def _stack_layers(layers, leaf_fn):
    """A per-layer list of trees -> one tree whose leaves are
    leaf_fn([the layers' leaves]) (np.stack for a state)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers], leaf_fn)
                for k in first}
    return leaf_fn(layers)


def _host(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def _tree_to_jax(tree, leaf_fn, one_fn):
    """A params-shaped tree (params, a moment tree, grad_err) in the JAX
    layout: "layers" stacked with leaf_fn, every other leaf through
    one_fn. The VLM's "groups" are not stacked: its training is not
    ported."""
    if "groups" in tree:
        raise NotImplementedError("the VLM's train state has no JAX-layout "
                                  "conversion (its training is not ported)")
    out = {}
    for k, v in tree.items():
        out[k] = (_stack_layers(v, leaf_fn) if k == "layers"
                  else _map_leaves(v, one_fn))
    return out


def _map_leaves(node, fn):
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    return fn(node)


def train_state_to_numpy(state, leaf_fn=None, one_fn=None):
    """The port's train state -> the JAX layout, numpy leaves (host
    copies; "layers" stacked). `leaf_fn` / `one_fn` replace the stacking
    and the host copy (a restore template needs only the structure)."""
    leaf_fn = leaf_fn or (lambda ls: np.stack([_host(l) for l in ls]))
    one_fn = one_fn or _host
    out = {"params": _tree_to_jax(state["params"], leaf_fn, one_fn),
           "opt": {"step": one_fn(state["opt"]["step"]),
                   "m": _tree_to_jax(state["opt"]["m"], leaf_fn, one_fn),
                   "v": _tree_to_jax(state["opt"]["v"], leaf_fn, one_fn)}}
    if "grad_err" in state:
        out["grad_err"] = _tree_to_jax(state["grad_err"], leaf_fn, one_fn)
    return out


def train_state_from_numpy(tree, device: DeviceLike = None):
    """A JAX train state (numpy) -> the port's: params, AdamW state (f32
    moments, or int8 {"q", "scale"[, "ef"]} dicts) and, with int8_ef,
    grad_err, every "layers" stack split into per-layer dicts."""
    dev = resolve_device(device)
    out = {"params": params_from_numpy(tree["params"], dev),
           "opt": {"step": _tensor(tree["opt"]["step"], dev),
                   "m": params_from_numpy(tree["opt"]["m"], dev),
                   "v": params_from_numpy(tree["opt"]["v"], dev)}}
    if "grad_err" in tree:
        out["grad_err"] = params_from_numpy(tree["grad_err"], dev)
    return out
