"""Production mesh definitions.

A FUNCTION, not a module-level constant: importing this module never
touches the process group.  A mesh is a ``torch.distributed``
``DeviceMesh`` over the group's ranks, so the group must exist first
(``repro_torch.distributed.runtime.initialize``, ``torchrun``, or a fake
group for a dry run: ``launch/hlo_analysis.fake_group``).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 chips per pod; multi_pod adds the 2-pod outer axis.
    ``device_type`` None: CUDA when there is a card, else the CPU."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_mesh(shape, axis_names, device_type=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names`` over the group's first
    ranks, row-major (the reference's ``make_mesh``); every rank of the
    group must call it."""
    import torch.distributed as dist

    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() == n:
        return init_device_mesh(device_type or _device_type(), tuple(shape),
                                mesh_dim_names=tuple(axis_names))
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def dp_axes(mesh) -> tuple:
    """The pure-data-parallel axes: ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)
