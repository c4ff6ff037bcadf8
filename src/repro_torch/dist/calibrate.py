"""Data-parallel COMQ calibration and column-sharded solves (port of
`repro.dist.calibrate`).

The calibration batch is sharded over the mesh's "data" axis: every rank
runs the tap forwards on its own rows, and the only communication the
walk needs is one all-reduce of each (m, m) Gram. With a nontrivial
"model" axis the per-channel solves run with W's output columns sharded
over "model" (`sharded_solve`): H and the shared visit order are
replicated, each rank solves its column slice with the unmodified solver,
and the solve itself issues no collective. JAX leaves the outputs sharded
and XLA gathers them where the forward reads them; here every rank runs
the forward itself, so one gather over "model" follows each sharded solve
and is its only collective.

Two forms of the Gram: `reduce_gram` / `reduce_batched_gram` take the
rank's own rows (what the walk holds), `sharded_gram` /
`sharded_batched_gram` take the whole tap on every rank, as JAX's do, and
fall back to the replicated Gram, with JAX's warning, where the data axis
does not divide it.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist.sharding import (axis_group, axis_rank, axis_size,
                                       column_slice)

Tensor = torch.Tensor

# obs hook: fires once per Gram all-reduce with its byte count, from static
# shapes on the host (no device sync, no cost when unset). The pipeline
# installs its `dist.bytes_all_reduced` counter here for a run.
_allreduce_observer = None


def set_allreduce_observer(cb):
    """Install `cb(n_bytes)` (or None to clear); returns the previous
    observer so callers can restore it."""
    global _allreduce_observer
    prev = _allreduce_observer
    _allreduce_observer = cb
    return prev


def _observe(n_bytes: int) -> None:
    if _allreduce_observer is not None:
        _allreduce_observer(n_bytes)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n: Optional[int] = None):
    """1-axis ("data",) mesh over the world's n ranks (default: all)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = n or world
    if n != world:
        raise ValueError(f"data mesh of {n} ranks in a world of {world}: "
                         "every rank must be on the mesh")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=("data",))


def calib_mesh(model: int = 1, data: Optional[int] = None):
    """("data", "model") calibration mesh over the world: the batch and
    the Gram all-reduce use "data", the solve's columns shard over
    "model". With data=None the data axis takes every rank the model axis
    leaves. Ranks are laid out row-major, as JAX reshapes its devices."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} must divide {n} devices")
    data = n // model if data is None else data
    if data < 1 or data * model > n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"devices, have {n}")
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) leaves "
                         f"{n - data * model} of {n} ranks off the mesh; "
                         "run as many ranks as the mesh has")
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def model_size(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, "model")


def shard_batch(mesh, x: Tensor) -> Tensor:
    """This rank's contiguous slice of x's leading (batch) axis over the
    "data" axis."""
    ndata = axis_size(mesh, "data")
    if x.shape[0] % ndata:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by data axis {ndata}")
    per = x.shape[0] // ndata
    lo = axis_rank(mesh, "data") * per
    return x[lo:lo + per]


def _all_reduce_data(mesh, h: Tensor) -> Tensor:
    """Sum h over the "data" axis: one all-reduce, or none on an axis of
    one (where JAX's psum compiles away)."""
    if axis_size(mesh, "data") > 1:
        dist.all_reduce(h, group=axis_group(mesh, "data"))
    return h


def reduce_gram(mesh, shard: Tensor) -> Tensor:
    """(b, T, d) rows of this rank -> the replicated (d, d) Gram over the
    whole batch: the local XᵀX in f32 and one all-reduce over "data", the
    only traffic of the calibration walk."""
    x2 = shard.reshape(-1, shard.shape[-1]).float()
    h = _all_reduce_data(mesh, x2.T @ x2)
    _observe(int(h.shape[0]) * int(h.shape[1]) * 4)
    return h


def reduce_batched_gram(mesh, shard: Tensor) -> Tensor:
    """(E, C, d) expert buckets holding this rank's rows (the others' are
    zero) -> the replicated (E, d, d) per-expert Grams, one all-reduce.
    Warns, as JAX does, when the capacity does not divide the data axis:
    the routing capacity was not aligned (BuildPlan.moe_capacity_multiple)."""
    if shard.shape[1] % axis_size(mesh, "data"):
        warnings.warn(
            f"reduce_batched_gram: expert capacity {shard.shape[1]} does not "
            f"divide the data axis {axis_size(mesh, 'data')}; align the "
            "routing capacity (BuildPlan.moe_capacity_multiple)",
            stacklevel=2)
    t = shard.float()
    hs = _all_reduce_data(mesh, torch.bmm(t.transpose(1, 2), t))
    _observe(int(hs.shape[0]) * int(hs.shape[1]) * int(hs.shape[2]) * 4)
    return hs


def sharded_gram(mesh, tap: Tensor) -> Tensor:
    """(B, T, d) tap, the same on every rank -> replicated (d, d) Gram:
    each rank takes its batch rows and `reduce_gram` sums them. A batch the
    data axis does not divide falls back to the replicated Gram, with
    JAX's warning."""
    if tap.shape[0] % axis_size(mesh, "data"):
        warnings.warn(
            f"sharded_gram: tap batch {tap.shape[0]} does not divide the "
            f"data axis {axis_size(mesh, 'data')}; falling back to the "
            "replicated Gram (no psum) for this tap", stacklevel=2)
        from repro_torch.core.calibrate import gram_from_tap
        return gram_from_tap(tap)
    return reduce_gram(mesh, shard_batch(mesh, tap))


def sharded_batched_gram(mesh, tap: Tensor) -> Tensor:
    """(E, C, d) stacked-expert tap, the same on every rank -> replicated
    (E, d, d) per-expert Grams: each rank takes its slice of the capacity
    axis and one all-reduce sums them. A capacity the data axis does not
    divide falls back to the replicated Grams, with JAX's warning."""
    ndata = axis_size(mesh, "data")
    if tap.shape[1] % ndata:
        warnings.warn(
            f"sharded_batched_gram: expert capacity {tap.shape[1]} does not "
            f"divide the data axis {ndata}; falling back to "
            "the replicated per-expert Gram (no psum). Align the routing "
            "capacity (BuildPlan.moe_capacity_multiple) to stay on the "
            "psum path.", stacklevel=2)
        from repro_torch.core.calibrate import batched_gram
        return batched_gram(tap)
    per = tap.shape[1] // ndata
    lo = axis_rank(mesh, "data") * per
    return reduce_batched_gram(mesh, tap[:, lo:lo + per])


# ---------------------------------------------------------------------------
# column-sharded solves
# ---------------------------------------------------------------------------

def _local_solve(h: Tensor, w: Tensor, perm: Tensor, spec, method: str,
                 block: int):
    """One rank's column slice: the unmodified solver, then the per-column
    squared errors of its codes and of RTN (`_col_err2`), all local."""
    from repro_torch.core.baselines import rtn_quantize
    from repro_torch.core.comq_hessian import comq_quantize_blocked
    from repro_torch.core.pipeline import _col_err2
    if method == "comq_blocked":
        r = comq_quantize_blocked(h, w, spec, block=block, perm=perm)
    elif method == "rtn":
        r = rtn_quantize(w, spec, h=h)
    else:
        raise ValueError(f"method {method!r} is not column-shardable")
    e2_after = _col_err2(h, w, r.q.float() * r.delta)
    rt = rtn_quantize(w, spec)
    e2_before = _col_err2(h, w, rt.q.float() * rt.delta)
    return r.q, r.delta, r.z_lo, e2_before, e2_after


def gather_columns(mesh, cols: Tensor) -> Tensor:
    """(rows, n_local) on each rank of "model" -> (rows, size·n_local), the
    ranks' slices side by side in rank order: one all-gather over the model
    group."""
    size = axis_size(mesh, "model")
    parts = [torch.empty_like(cols) for _ in range(size)]
    dist.all_gather(parts, cols.contiguous(), group=axis_group(mesh, "model"))
    return torch.cat(parts, dim=1)


def sharded_solve(mesh, h: Tensor, w2d: Tensor, spec, method: str,
                  block: int = 256):
    """Column-sharded COMQ solve: W's output columns partition over the
    "model" axis (zero-padded at the end to a multiple of it); H and the
    shared visit order are replicated and the solve issues no collective.
    Then one gather over "model" gives every rank the whole result.

    Every column's arithmetic is the replicated solve's, so the codes are
    its codes wherever a matmul or reduction rounds a column the same
    whatever the column count: on the CPU (MKL) the codes and zero-points
    are the replicated solve's bit for bit and the scales differ in the
    last bit (`torch.sum(dim=0)` tiles by the whole shape); on the card
    cuBLAS picks its f32 GEMM by the whole shape, so at m = 18944 the
    trailing updates round otherwise (PERF.md, "Column-sharded bit
    identity on the card").

    Returns (q, delta, z_lo, e2_before, e2_after) over the n columns:
    codes (m, n) int32, scales (n,), zero-points (n,) int32 and the
    per-column squared errors of RTN and of the solve."""
    from repro_torch.core.comq_hessian import shared_order
    tp = model_size(mesh)
    h = h.float()
    w2d = w2d.float()
    m, n = w2d.shape
    lo, hi, n_pad = column_slice(n, axis_rank(mesh, "model"), tp)
    wp = F.pad(w2d, (0, n_pad - n)) if n_pad != n else w2d
    if method == "comq_blocked":
        # the one column-coupled quantity, from the full unpadded W, so
        # the order, and with it every code, is the replicated solve's
        perm = shared_order(h, w2d, spec)
    else:
        perm = torch.arange(m, device=h.device)
    q, delta, z_lo, e2b, e2a = _local_solve(h, wp[:, lo:hi].contiguous(),
                                            perm, spec, method, block)
    # one gather: codes and zero-points are small integers, exact in f32
    packed = torch.cat([q.float(), delta.float()[None], z_lo.float()[None],
                        e2b[None], e2a[None]])
    full = gather_columns(mesh, packed)[:, :n]
    return (full[:m].to(torch.int32), full[m].contiguous(),
            full[m + 1].to(torch.int32), full[m + 2].contiguous(),
            full[m + 3].contiguous())

