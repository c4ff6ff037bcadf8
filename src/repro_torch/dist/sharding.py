"""Mesh layout: which rank holds which part of each tensor (port of
`repro.dist.sharding`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose axis names
are JAX's ("data", "model", and "pod" on the multi-pod mesh), or the
abstract production mesh of `launch.mesh.make_production_mesh` (axis
names and sizes only, for the dry run). Every rank runs the same program,
so a partition spec says which slice of a tensor one rank holds.

* `column_slice` — the column-sharded COMQ solve (`solver_specs`): W, the
  codes and the per-column grids partition over "model" along the output
  columns, with JAX's trailing zero-pad to a multiple of the axis; H and
  the shared visit order are replicated.
* `paged_layout` — the slot+page-sharded paged runtime
  (`paged_runtime_specs`): the pool's page dim and every per-slot
  operand's batch dim partition together over "model", so each rank
  decodes its own slots against its own pages.
* The GSPMD half, JAX's rules entry for entry: `param_specs` (Megatron TP
  over "model" on heads, FFN hidden, vocab and experts, FSDP over "data"
  on the other large dim; every sharded dim divisibility-checked),
  `input_batch_specs`, `cache_specs`, `batch_dim_spec` and
  `make_constrain`. A spec is a `PartitionSpec`, a tuple of the port's
  own with one entry per tensor dim (None, an axis name, or a tuple of
  names). The port's trees hold per-layer leaves where JAX stacks layers
  along leading dims, which JAX's rules leave replicated: a layer leaf's
  spec is the JAX spec without those leading None entries. `named(mesh,
  spec)` gives a `NamedSharding`, whose `shard_shape` sizes one rank's
  slice on any mesh and whose `placements()` are the DTensor placements
  on a `DeviceMesh` (the elastic restore's). There is no partitioner to
  hand a spec to: `make_constrain`'s callback returns its tensor as it
  is and records the spec it would pin.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.models.common import pad_to_multiple


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, what JAX's `mesh.shape` gives, of a DeviceMesh
    (or of anything with JAX's `shape` mapping)."""
    if mesh is None:
        return {}
    if not hasattr(mesh, "mesh_dim_names"):
        return {str(k): int(v) for k, v in dict(mesh.shape).items()}
    return {str(k): int(v) for k, v in zip(mesh.mesh_dim_names,
                                            mesh.mesh.shape)}


def axis_size(mesh, name: str) -> int:
    return int(mesh_shape(mesh).get(name, 1))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on axis `name` (0 when the mesh lacks it)."""
    if mesh is None or name not in mesh_shape(mesh):
        return 0
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name: str):
    """The process group of axis `name` that holds this rank."""
    return mesh.get_group(name)


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    return axis_size(mesh, "data") * axis_size(mesh, "pod")


def column_slice(n: int, rank: int, size: int) -> Tuple[int, int, int]:
    """The column-sharded solve's partition of n output columns over a
    model axis of `size`: (lo, hi, n_pad) with this rank's columns
    [lo, hi) of the zero-padded n_pad = n rounded up to a multiple of
    `size` (JAX pads at the end; columns are independent, so where the
    pad sits cannot change a code)."""
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a model axis of {size}")
    n_pad = pad_to_multiple(n, size)
    per = n_pad // size
    return rank * per, (rank + 1) * per, n_pad


def paged_layout(tp: int, max_slots: int, num_blocks: int,
                 rank: Optional[int] = None) -> Dict[str, int]:
    """Slot+page layout of the TP paged runtime: each of the `tp` ranks
    holds `num_blocks // tp` pages and `max_slots // tp` slots, rank r the
    pages [r·nbl, (r+1)·nbl) and the slots [r·spp, (r+1)·spp). Raises JAX's
    error when tp divides neither count."""
    if num_blocks % tp != 0 or max_slots % tp != 0:
        raise ValueError(
            f"TP paged runtime needs num_blocks ({num_blocks}) and "
            f"max_slots ({max_slots}) divisible by the model axis ({tp})")
    out = {"blocks": num_blocks // tp, "slots": max_slots // tp}
    if rank is not None:
        out["block_lo"] = rank * out["blocks"]
        out["slot_lo"] = rank * out["slots"]
    return out


# ---------------------------------------------------------------------------
# the GSPMD half: partition specs (JAX's rules)
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the dim splits over their product, in order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def batch_axes(mesh):
    """The mesh axes a batch dim shards over: ("pod", "data") or "data"."""
    if "pod" in mesh_shape(mesh):
        return ("pod", "data")
    return "data"


def batch_dim_spec(mesh, global_batch: int):
    """PartitionSpec *entry* for a batch dim (None when it does not
    divide)."""
    b = batch_axes(mesh)
    return b if global_batch % dp_size(mesh) == 0 else None


def _axis_if(dim: int, axis, size: int):
    return axis if size > 1 and dim % size == 0 else None


# per-leaf TP rules: leaf name -> (tp_dim_from_end, fsdp_dim_from_end),
# JAX's. Dims count from the end, so JAX's leading layer-stack dims (which
# the port's per-layer leaves do not have) stay replicated. wq (d, Hp, hd):
# heads on TP, d on FSDP; wo (Hp, hd, d): heads TP, d FSDP. FFN up-
# projections shard the hidden f on TP and d on FSDP, down-projections the
# mirror. MoE experts shard E on TP (EP). wk / wv stay TP-replicated
# (n_kv_heads < the model axis).
_TP_RULES: Dict[str, Tuple[int, int]] = {
    "wq": (2, 3), "wo": (3, 1),
    "w_gate": (1, 2), "w_up": (1, 2), "w_down": (2, 1),
    "w_r": (1, 2), "w_k": (1, 2), "w_v": (2, 1), "w_g": (1, 2),
    "w_o": (1, 2), "w_in": (1, 2), "w_out": (1, 2),
    "unembed": (1, 2), "cls_head": (1, 2), "vision_proj": (1, 2),
}
_MOE_RULES: Dict[str, Tuple[int, int]] = {
    "w_gate": (3, 2), "w_up": (3, 2), "w_down": (3, 2),
}


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> P:
    tp, dp = tp_size(mesh), axis_size(mesh, "data")
    name = path[-1] if path else ""
    ndim = len(shape)
    spec: List[Any] = [None] * ndim
    rules = (_MOE_RULES if "moe" in path and name in _MOE_RULES
             else _TP_RULES)
    if name == "embed" and ndim >= 2:
        # vocab rows on TP (padded to 256-multiples), d on FSDP
        spec[-2] = _axis_if(shape[-2], "model", tp)
        spec[-1] = _axis_if(shape[-1], "data", dp)
        return P(*spec)
    if name in rules and ndim >= rules[name][0]:
        tdim, fdim = rules[name]
        spec[-tdim] = _axis_if(shape[-tdim], "model", tp)
        if ndim >= fdim and fdim != tdim:
            spec[-fdim] = _axis_if(shape[-fdim], "data", dp)
        return P(*spec)
    # fallback: FSDP-shard the last dim of anything big, replicate the rest
    if ndim >= 1 and shape[-1] >= 1024:
        spec[-1] = _axis_if(shape[-1], "data", dp)
    return P(*spec)


def _is_qt(x) -> bool:
    from repro_torch.core.apply import is_qt
    return is_qt(x)


def _walk_specs(tree, mesh, path=()):
    if isinstance(tree, dict):
        return {k: _walk_specs(v, mesh, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_walk_specs(v, mesh, path) for v in tree)
    if _is_qt(tree):
        from repro_torch.core.apply import qt_spec
        return qt_spec(tree, _leaf_spec(path, tree.shape, mesh))
    return _leaf_spec(path, tuple(tree.shape), mesh)


def param_specs(params, mesh):
    """Megatron-TP + FSDP PartitionSpecs for a params tree (by leaf name,
    divisibility-checked), JAX's `param_specs`. A QT leaf gets a QT of
    specs (`core.apply.qt_param_specs`' rule: the codes inherit the dense
    leaf's spec, the scale and zero-point drop the last axis)."""
    return _walk_specs(params, mesh)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def input_batch_specs(inputs, mesh, global_batch: int):
    """Shard every input's leading batch dim over the batch axes."""
    b = batch_dim_spec(mesh, global_batch)

    def one(t):
        if t.dim() == 0:
            return P()
        return P(*((b,) + (None,) * (t.dim() - 1)))

    return _map_tensors(one, inputs)


def cache_specs(cache, mesh, global_batch: int):
    """Decode / prefill cache specs: the batch dim (located by size) shards
    over the batch axes; the (..., KV, hd) tail puts KV on "model" when
    the KV count divides, else splits hd when it divides into at least
    two a rank."""
    b = batch_dim_spec(mesh, global_batch)
    tp = tp_size(mesh)

    def one(t):
        shp = tuple(t.shape)
        spec: List[Any] = [None] * len(shp)
        for i, d in enumerate(shp):
            if d == global_batch and b is not None:
                spec[i] = b
                break
        if len(shp) >= 2:
            kv, hd = shp[-2], shp[-1]
            if kv % tp == 0 and tp > 1 and spec[-2] is None:
                spec[-2] = "model"
            elif hd % tp == 0 and tp > 1 and hd >= 2 * tp:
                spec[-1] = "model"
        return P(*spec)

    return _map_tensors(one, cache)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(spec, global_shape, mesh) -> Tuple[int, ...]:
    """One rank's slice of a tensor of `global_shape` under `spec` (a dim
    that its axes do not divide takes the ceiling, as a padded shard)."""
    sizes = mesh_shape(mesh)
    out = []
    for i, d in enumerate(global_shape):
        n = math.prod(sizes.get(a, 1) for a in
                      _axes(spec[i] if i < len(spec) else None))
        out.append(-(-int(d) // n))
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (JAX's `NamedSharding`)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec!r})"

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        return shard_shape(self.spec, global_shape, self.mesh)

    def placements(self):
        """The DTensor placements on a `DeviceMesh`, one per mesh axis:
        Shard(dim) where the spec splits dim over that axis, else
        Replicate()."""
        from torch.distributed.tensor import Replicate, Shard
        if not hasattr(self.mesh, "mesh_dim_names"):
            raise TypeError("placements need a DeviceMesh; this mesh is "
                            f"abstract: {mesh_shape(self.mesh)}")
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, e in enumerate(self.spec) if name in _axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def splits(self) -> bool:
        """Whether the spec splits a tensor dim over an axis larger than
        one."""
        sizes = mesh_shape(self.mesh)
        return any(sizes.get(a, 1) > 1 for e in self.spec for a in _axes(e))


def named(mesh, specs):
    """PartitionSpec tree -> NamedSharding tree."""
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if _is_qt(specs):
        from repro_torch.core.apply import QT
        return QT(named(mesh, specs.codes), named(mesh, specs.scale),
                  named(mesh, specs.z_lo), specs.shape, specs.bits,
                  cpb=specs.cpb)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(named(mesh, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(named(mesh, v) for v in specs)
    return specs


def local_bytes(tree, specs, mesh) -> int:
    """Σ over the leaves of one rank's slice in bytes: each tensor of
    `tree` (QT leaves by their codes, scale and zero-point) under the
    matching spec of `specs`."""
    total = 0

    def walk(t, s):
        nonlocal total
        if t is None:
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        elif _is_qt(t):
            for a, b in ((t.codes, s.codes), (t.scale, s.scale),
                         (t.z_lo, s.z_lo)):
                walk(a, b)
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, s):
                walk(a, b)
        else:
            total += (math.prod(shard_shape(s, tuple(t.shape), mesh))
                      * t.element_size())

    walk(tree, specs)
    return total


def make_constrain(mesh, global_batch: int, *, seq_shard: bool = False,
                   block_gather: bool = False, ffn_shard: bool = False):
    """Activation-sharding callback for `BuildPlan.constrain`: JAX's spec
    for each kind. "residual" (B, T, d): batch over the batch axes, seq
    over "model" under sequence parallelism; "block_in": the Megatron-SP
    gather entering a block (unless block_gather keeps seq sharded);
    "logits" (B, T, V): vocab over "model"; "ffn_hidden" (B, T, f):
    hidden over "model" when ffn_shard; "kv_cache": `cache_specs`. The
    callback returns its input unchanged (no partitioner takes the spec)
    and appends (kind, spec) to its `.specs` list; `.spec_of(x, kind)`
    computes a spec without recording it (None: no constraint). The
    record keeps the last 4096 calls."""
    b = batch_dim_spec(mesh, global_batch)
    tp = tp_size(mesh)

    def spec_of(x, kind: str):
        if kind == "kv_cache":
            return cache_specs(x, mesh, global_batch)
        if kind == "residual":
            seq = "model" if seq_shard and x.shape[1] % tp == 0 else None
            return P(b, seq, None)
        if kind == "block_in":
            return P(b, None, None) if seq_shard and not block_gather \
                else None
        if kind == "logits":
            return P(b, None, _axis_if(x.shape[-1], "model", tp))
        if kind == "ffn_hidden":
            return P(b, None, _axis_if(x.shape[-1], "model", tp)) \
                if ffn_shard else None
        return None

    def constrain(x, kind: str):
        constrain.specs.append((kind, spec_of(x, kind)))
        return x

    constrain.specs = collections.deque(maxlen=4096)
    constrain.spec_of = spec_of
    return constrain
