"""Mesh builders (port of `repro.launch.mesh`). `make_production_mesh`
(the 16×16 pod) belongs to the dry run and is not here."""
from __future__ import annotations

from repro_torch.device import DeviceLike


def make_smoke_mesh(device: DeviceLike = "cpu"):
    """JAX's smoke mesh: (1, 1) with axes ("data", "model"), over a world
    of one (started here on `device` when no process group runs; end it
    with `repro_torch.dist.close_world(True)`)."""
    from repro_torch import dist as rd
    rd.init_world(device=device)
    return rd.calib_mesh(model=1, data=1)
