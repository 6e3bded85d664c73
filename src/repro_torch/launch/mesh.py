"""Mesh construction.

The port of ``repro.launch.mesh``.  A mesh here is first a
:class:`~repro_torch.core.dataplane.DeviceGrid` (pool devices in a
(dp, tp) grid, or its shape alone when no devices are given); a
``torch.distributed`` ``DeviceMesh`` is built from it once the process
group is up (:func:`device_mesh`, which ``launch/spmd.py`` calls in every
rank).  Functions, not module constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from repro_torch.core.dataplane import DeviceGrid


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The production (16, 16) or (2, 16, 16) mesh's axis-name -> size
    shape (what ``Plan.for_mesh`` reads; no host here has its 256 or 512
    devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_mesh_for(n_devices: int, *, tp: int = 1,
                  axis_names=("data", "model"),
                  devices: Optional[Sequence] = None
                  ) -> Union[DeviceGrid, Dict[str, int]]:
    """Smaller meshes for pilots/tests: (n_devices // tp, tp), a
    DeviceGrid over `devices` or its shape."""
    assert n_devices % tp == 0, (n_devices, tp)
    if devices is None:
        return dict(zip(axis_names, (n_devices // tp, tp)))
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices}")
    return DeviceGrid(devices, tp, axis_names)


def device_mesh(grid: DeviceGrid):
    """The ``DeviceMesh`` of `grid` in this process's group (whose world
    size must be ``grid.size``): the grid's shape and axis names on its
    device type."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = next(iter(grid.devices.flat)).type
    return init_device_mesh(kind, tuple(grid.devices.shape),
                            mesh_dim_names=tuple(grid.axis_names))
