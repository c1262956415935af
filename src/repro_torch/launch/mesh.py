"""Device meshes (the port of ``repro.launch.mesh``).

A mesh axis of the reference becomes a dimension of a
``torch.distributed.device_mesh.DeviceMesh``, and the fabric's channels
use that dimension's process group (``mesh.get_group(axis)``). Every rank
calls these functions, after ``torch.distributed.init_process_group``
(``launch.world`` starts such ranks); the mesh spans the default group's
ranks. They are functions, so importing this module touches no device and
no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve


def _mesh(shape, axes, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed.init_process_group "
                           "first (launch.world starts initialised ranks)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the world holds {world}")
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production shapes: 16 × 16 = 256 ranks (one pod),
    or 2 × 16 × 16 = 512 (two pods, the leading ``pod`` axis the
    cross-pod data-parallel dimension). Raises ValueError when the world
    does not hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device="cuda") -> DeviceMesh:
    """A small mesh over the whole world (tests pass ``device="cpu"``)."""
    return _mesh(shape, axes, device)
