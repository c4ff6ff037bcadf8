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

Neither imports JAX: the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree(node, dev):
    if isinstance(node, dict):
        return {k: _tree(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(v, dev) for v in node]
    if isinstance(node, (np.ndarray, np.generic)):
        return _tensor(node, dev)
    return node


def _layer_slice(node, i: int):
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    return node[i]


def _n_stacked(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
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
