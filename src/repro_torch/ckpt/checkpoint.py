"""Checkpointing: atomic and async (port of `repro.ckpt.checkpoint`).

Layout:  <dir>/step_<N>/
             arrays.npz          flattened tree leaves (key = path)
             treedef.json        metadata (step, extra, time)
             _COMMITTED          sentinel written last (atomicity marker)

* **Atomic**: writes go to `step_<N>.tmp/`; every file and the tmp
  directory are fsynced, the directory is renamed into place, and the
  parent is fsynced after it, so a crash mid-write never leaves a
  checkpoint that `latest_step` picks up.
* **Async**: `save(..., blocking=False)` copies every tensor to host numpy
  synchronously (`.cpu()`) and runs only the write on a background thread
  (at most one in flight).

The npz keys are the JAX package's (`jax.tree_util.tree_flatten_with_path`
joined by "/"): dict keys in sorted order, "[i]" for list and tuple items,
None an empty subtree, and every other leaf (tensor, array, bool, int,
float) one array, a Python scalar as a 0-d array. So either package
restores the other's `step_N` directories. `restore(device=)` places the
tensors; `restore(shardings=)` is the elastic path, JAX's re-shard onto
another topology: each leaf goes to its `dist.sharding.NamedSharding`'s
`DeviceMesh` through `torch.distributed.tensor.distribute_tensor`, a
DTensor whose local shard is this rank's slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike

Tree = Any
SENTINEL = "_COMMITTED"


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (some platforms refuse to fsync a
    directory: best effort there)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _children(node):
    """(path part, child) pairs of an inner node, in JAX's flatten order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Tree) -> Dict[str, Any]:
    """{"a/b/[0]": leaf, ...} in the order and with the keys of the JAX
    package's `_flatten_with_paths`."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out["/".join(prefix)] = node
            return
        for part, child in kids:
            walk(child, prefix + [part])

    walk(tree, [])
    return out


def _unflatten(like: Tree, leaves: Iterator[Any]) -> Tree:
    """`like` with its leaves replaced, in flatten order, from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        done = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array that no later write to the leaf can change."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.array(leaf)


def _like_leaf(arr: np.ndarray, like, device: DeviceLike):
    """A restored array in the form of its template leaf: a tensor on
    `device` (default: the template's), a numpy array, or a Python
    scalar of the template's type."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        return t.to(device if device is not None else like.device)
    if isinstance(like, np.ndarray):
        return arr
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _distribute(leaf, sharding, key: str):
    """A restored leaf on its sharding's DeviceMesh (a DTensor), or as it
    is for no sharding."""
    if sharding is None:
        return leaf
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    if len(sharding.spec) > t.dim():
        raise ValueError(f"{key}: spec {sharding.spec!r} has more entries "
                         f"than the leaf's {t.dim()} dims")
    t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, sharding.placements())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- discovery ----------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(path, SENTINEL)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None,
             blocking: bool = True):
        """Copy to host memory now; write now or on the saver thread."""
        self.wait()  # at most one async save in flight
        host = {k: _to_host(v) for k, v in flatten_with_paths(tree).items()}
        meta = {"step": step, "extra": extra or {}, "time": time.time()}
        if blocking:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, step, host, meta):
        try:
            self._write(step, host, meta)
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: Dict):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "treedef.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, SENTINEL), "w") as f:
            f.write("ok")
        # fsync every file and the tmp dir before the rename, the parent
        # after: the rename alone orders nothing on most filesystems
        for name in os.listdir(tmp):
            _fsync_path(os.path.join(tmp, name))
        _fsync_path(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(self.dir)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, step: Optional[int], like: Tree,
                shardings: Optional[Tree] = None, device: DeviceLike = None):
        """Restore into the structure of `like` (see `_like_leaf` for each
        leaf's form); `device` places the tensor leaves. `shardings` (the
        structure of `like`, `NamedSharding` leaves on a DeviceMesh, None
        for a leaf to leave as it is) places each tensor leaf as a DTensor
        with the sharding's placements: every rank reads the whole array
        and keeps its slice. Returns (tree, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        data = np.load(os.path.join(path, "arrays.npz"))
        with open(os.path.join(path, "treedef.json")) as f:
            meta = json.load(f)

        flat_like = flatten_with_paths(like)
        keys = list(flat_like)
        missing = [k for k in keys if k not in data.files]
        # state grown after the checkpoint was written is backfilled from
        # the template: the int8 first-moment "ef" residual and the
        # "grad_err" carry; anything else missing is fatal
        optional = [k for k in missing
                    if k.split("/")[-1] == "ef" or k.startswith("grad_err")]
        hard = [k for k in missing if k not in optional]
        if hard:
            raise KeyError(f"checkpoint missing {len(hard)} leaves, e.g. "
                           f"{hard[:3]}")
        if optional:
            warnings.warn(f"checkpoint predates {len(optional)} optional "
                          f"state leaves (e.g. {optional[:2]}); backfilling "
                          "from the initialized template", stacklevel=2)
        leaves = [_like_leaf(data[k], flat_like[k], device)
                  if k in data.files else flat_like[k] for k in keys]
        if shardings is not None:
            flat_sh = flatten_with_paths(shardings)
            leaves = [_distribute(leaf, flat_sh.get(k), k)
                      for k, leaf in zip(keys, leaves)]
        return _unflatten(like, iter(leaves)), meta
