"""Convert JAX-package parameter trees (as numpy arrays, e.g. from
`jax.device_get`) into the port's layout, so both packages compute on the
same weights.

* `params_from_numpy`: `{"embed", "unembed", "final_norm", "layers"}` with
  "layers" a tree of (L, ...) stacks -> "layers" a per-layer list of dicts
  with the same leaf names and per-layer shapes.
* `qparams_from_numpy`: additionally converts a `quantize_model` output's
  "__qlayers__" QTensor side table.

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


def params_from_numpy(tree, device: DeviceLike = None):
    """JAX dense-family params (numpy) -> the port's params."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items()
           if k not in ("layers", "__qlayers__")}
    if "layers" in tree:
        leaves = []
        stack = [tree["layers"]]
        while stack:
            n = stack.pop()
            if isinstance(n, dict):
                stack.extend(n.values())
            else:
                leaves.append(n)
        L = int(leaves[0].shape[0])
        out["layers"] = [_tree(_layer_slice(tree["layers"], i), dev)
                         for i in range(L)]
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
