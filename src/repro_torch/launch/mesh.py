"""Mesh builders (port of `repro.launch.mesh`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.device import DeviceLike


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices and no process group: what
    the dry run's spec arithmetic reads (`dist.sharding.mesh_shape`)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """JAX's production mesh, 16 x 16 ("data", "model"); multi-pod adds a
    leading "pod" axis of 2 (2 x 16 x 16). Abstract: the dry run sizes
    every rank's slice on it without devices."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_smoke_mesh(device: DeviceLike = "cpu"):
    """JAX's smoke mesh: (1, 1) with axes ("data", "model"), over a world
    of one (started here on `device` when no process group runs; end it
    with `repro_torch.dist.close_world(True)`)."""
    from repro_torch import dist as rd
    rd.init_world(device=device)
    return rd.calib_mesh(model=1, data=1)
