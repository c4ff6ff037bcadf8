"""Quantized checkpoint format: COMQ codes packed to their bit width (port
of `repro.ckpt.quantized`).

`pack_tree`/`unpack_tree` convert between the pipeline's QTensor tree and
the storage form; `policy_extra`/`restore_policy` carry the QuantPolicy
in the metadata. `save_packed_ckpt` writes one self-describing file —
a format/version header plus a crc32 over the pickled payload — whose
arrays are numpy arrays, never torch tensors, so the JAX package's
`load_packed_ckpt` reads what the port writes (and the other way round).
Like any pickle, load only files this program wrote.
"""
from __future__ import annotations

import os
import pickle
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import is_qtensor, qtensor_bits
from repro_torch.core.quantizer import pack_codes, unpack_codes


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def pack_tree(tree):
    def walk(node):
        if is_qtensor(node):
            codes = node["codes"]
            packed, cpb = pack_codes(codes, qtensor_bits(node))
            out = dict(node)
            if cpb > 1:
                out["codes"] = packed
                out["packed_cpb"] = cpb
                out["unpacked_last"] = int(codes.shape[-1])
                if cpb == 2:
                    out["packed4"] = True   # alias for older readers
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)


def unpack_tree(tree):
    def walk(node):
        if is_qtensor(node):
            out = dict(node)
            cpb = out.pop("packed_cpb", None)
            if cpb is None and out.get("packed4"):
                cpb = 2
            out.pop("packed4", None)
            if cpb:
                out["codes"] = unpack_codes(node["codes"], int(cpb))
                out.pop("unpacked_last", None)
            if "bits" not in out:
                out["bits"] = 4 if cpb == 2 else 8
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)


def policy_extra(policy=None, arch: Optional[str] = None,
                 **kw) -> Dict[str, Any]:
    """Checkpoint metadata for a quantized save: the arch plus the
    serialized QuantPolicy (`core.policy.policy_to_dict`), so a restore
    rebuilds the exact per-leaf bit assignment. `save_packed_ckpt(path,
    tree, **policy_extra(...))` stores it beside the tree."""
    out: Dict[str, Any] = dict(kw)
    if arch is not None:
        out["arch"] = arch
    if policy is not None:
        from repro_torch.core.policy import as_policy, policy_to_dict
        out["policy"] = policy_to_dict(as_policy(policy))
    return out


def restore_policy(extra: Dict[str, Any]):
    """Inverse of policy_extra: the QuantPolicy a checkpoint was solved
    under (from `load_packed_ckpt`'s payload), or None when it has none."""
    if not extra or "policy" not in extra:
        return None
    from repro_torch.core.policy import policy_from_dict
    return policy_from_dict(extra["policy"])


def strip_for_serving(qparams):
    """Drop the dense copies of quantized layers from a `quantize_model`
    output — the on-disk checkpoint form. Everything serving needs
    survives: the top-level params and the "__qlayers__" table, which
    holds each layer's dense non-quantized leaves (norms, biases) beside
    its QTensors. `core.apply.serving_params` and `core.materialize` both
    accept the stripped form."""
    return {k: v for k, v in qparams.items() if k not in ("layers", "groups")}


def tree_bytes(tree) -> int:
    total = 0

    def add(leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
        return leaf

    _map_tree(add, tree)
    return total


def to_host(tree):
    """Every torch tensor of `tree` as a numpy array (the storage form)."""
    return _map_tree(lambda a: a.detach().cpu().numpy()
                     if isinstance(a, torch.Tensor) else a, tree)


PACKED_FORMAT = "comq-packed-qt"
PACKED_VERSION = 1


class PackedCkptError(RuntimeError):
    """A packed quantized checkpoint failed validation (truncated file,
    checksum mismatch, wrong format/version)."""


def save_packed_ckpt(path: str, tree, fault_cb=None, **meta) -> int:
    """Write a packed quantized tree as one self-describing file, atomically
    (tmp + fsync + rename). Torch tensors are stored as numpy arrays.
    `fault_cb` (fault injection) runs between the durable tmp write and the
    rename: the torn-write window the quantization journal's ordering must
    survive. Returns the payload crc32 (what the journal records per
    spilled leaf)."""
    payload = pickle.dumps({"tree": to_host(tree), **meta})
    crc = zlib.crc32(payload)
    blob = {"format": PACKED_FORMAT, "version": PACKED_VERSION,
            "crc32": crc, "payload": payload}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f)
        f.flush()
        os.fsync(f.fileno())
    if fault_cb is not None:
        fault_cb()
    os.replace(tmp, path)
    return crc


def load_packed_ckpt(path: str, expect_crc: Optional[int] = None
                     ) -> Dict[str, Any]:
    """Load + validate a packed checkpoint written by either package;
    returns the payload dict ({"tree": ..., **meta}) with numpy arrays
    (`repro_torch.convert.qparams_from_numpy` moves a table to torch)."""
    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError) as e:
        raise PackedCkptError(
            f"{path}: not a readable packed checkpoint — the file is "
            f"truncated or corrupt ({type(e).__name__}: {e})") from e
    if not isinstance(blob, dict) or blob.get("format") != PACKED_FORMAT:
        raise PackedCkptError(f"{path}: not a {PACKED_FORMAT!r} file")
    if blob["version"] > PACKED_VERSION:
        raise PackedCkptError(
            f"{path}: version {blob['version']} is newer than this reader "
            f"({PACKED_VERSION})")
    payload = blob["payload"]
    crc = zlib.crc32(payload)
    if crc != blob["crc32"]:
        raise PackedCkptError(
            f"{path}: checksum mismatch (stored {blob['crc32']:#010x}, "
            f"computed {crc:#010x}) — the checkpoint is corrupt")
    if expect_crc is not None and crc != int(expect_crc):
        raise PackedCkptError(
            f"{path}: checksum {crc:#010x} does not match the expected "
            f"{int(expect_crc):#010x}")
    return pickle.loads(payload)
