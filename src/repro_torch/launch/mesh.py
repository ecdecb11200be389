"""Production mesh definition over ``torch.distributed`` (functions, so
importing this module never touches a process group).

The port of ``repro/launch/mesh.py:18-41``, with its shapes and axis names:

Single pod:  (16, 16)     -> ("data", "model")          = 256 ranks
Multi-pod:   (2, 16, 16)  -> ("pod", "data", "model")   = 512 ranks

The ``pod`` axis is pure data parallelism (gradient reduction only): the
axis you grow to 1000+ nodes. ``data`` is FSDP + batch; ``model`` is
TP/EP/head sharding. A mesh here is a ``DeviceMesh`` over the ranks of the
default process group, which the caller has started
(``torch.distributed.init_process_group``; ``core.distributed.spawn_mesh``
starts ranks on one machine), one rank a device.
"""

from __future__ import annotations

import math

import torch


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: tuple, axes: tuple, device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    need = math.prod(shape)
    if _world() == need:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(need).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with ``pod``;
    over the first ranks when the world is larger."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = _world()
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {world} — "
            "start that many ranks (one a device) before building it.")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda"):
    """Small mesh for tests (gloo ranks on the CPU, or ranks on a card)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def batch_axes_of(mesh) -> tuple:
    """The pure-batch axes of a mesh (pod + data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
