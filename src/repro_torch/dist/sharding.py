"""Mesh layout helpers that mean something without GSPMD (port of the
non-GSPMD half of `repro.dist.sharding`).

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` whose axis
names are JAX's ("data", "model"); every rank runs the same program, so
a "partition spec" becomes the slice of a tensor that one rank holds:

* `column_slice` — the column-sharded COMQ solve (`solver_specs`): W, the
  codes and the per-column grids partition over "model" along the output
  columns, with JAX's trailing zero-pad to a multiple of the axis; H and
  the shared visit order are replicated.
* `paged_layout` — the slot+page-sharded paged runtime
  (`paged_runtime_specs`): the pool's page dim and every per-slot
  operand's batch dim partition together over "model", so each rank
  decodes its own slots against its own pages.

`param_specs`, `input_batch_specs`, `cache_specs`, `make_constrain` and
`named` drive GSPMD in the JAX package's dry run only; they are not here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
