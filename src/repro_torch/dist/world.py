"""The SPMD process world: one process per rank, every rank running the
same program (`python -m torch.distributed.run`), where the JAX package
runs one process over N devices.

`init_world` starts the default process group from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT), or, outside
torchrun, a world of one on an in-process store. Each rank runs on
`cuda:{LOCAL_RANK % device_count}`, made the current device, so the
port's kernels launch there on that device's current stream. The backend
is explicit: `nccl` where every rank has a card of its own, `gloo` on the
CPU and where ranks share one card (a transport choice only: the tensors
and every kernel stay on the card).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def default_backend(device: DeviceLike) -> str:
    """nccl on the card, gloo on the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    cuda:{LOCAL_RANK % device_count}, made the current device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    idx = local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def check_backend(backend: str, dev: torch.device) -> None:
    """Refuse what cannot work: an unknown backend, nccl on the CPU, and
    nccl with more ranks on this host than cards (nccl needs a card per
    rank; gloo carries CUDA tensors through host memory)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend != "nccl":
        return
    if dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA tensors; use gloo on "
                         "the CPU")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    if local_world > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs a card per rank, but {local_world} ranks share "
            f"{torch.cuda.device_count()} card(s) on this host; use "
            "--dist-backend gloo where ranks share a card")


def init_world(backend: Optional[str] = None, device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start the default process group if none is running, on this rank's
    device (`rank_device`). Returns (device, started): `started` is True
    when this call started the group, and then `close_world` ends it."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev, False
    backend = backend or default_backend(dev)
    check_backend(backend, dev)
    kw = {"backend": backend,
          "timeout": datetime.timedelta(seconds=timeout_s)}
    if "WORLD_SIZE" not in os.environ:
        # a world of one, outside torchrun: no rendezvous, no port
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev, True


def close_world(started: bool) -> None:
    if started and dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return rank() == 0


def barrier() -> None:
    """A world barrier (a no-op without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
