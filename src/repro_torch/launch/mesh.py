"""Device meshes, PyTorch port of ``src/repro/launch/mesh.py``.

The reference's production meshes keep their shapes: one pod is 16 x 16
devices on ``("data", "model")``, two pods 2 x 16 x 16 on ``("pod",
"data", "model")``.  Here a mesh is a ``torch.distributed`` device mesh
(``init_device_mesh``) over the default process group, which must exist
before a mesh is built (one process a device; the dry run's is a fake
group of 256 or 512 ranks).  Nothing happens at import.

On H100s a 16-wide ``model`` axis spans two 8-GPU NVLink nodes, so the
roofline's per-link rate (``launch/roofline.py::H100``) is optimistic
for it.

The spec helpers read only a mesh's axis names and sizes
(``axis_sizes``), so that they take a torch ``DeviceMesh``, the
reference's ``jax.sharding.Mesh`` or ``AbstractMesh``, or any object
whose ``shape`` maps axis names to sizes.
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh", "axis_sizes", "axis_names",
           "batch_axes", "fsdp_axis", "tensor_axis"]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A device mesh of ``shape`` named ``axes`` over the default process
    group, whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("build the default process group "
                           "(torch.distributed.init_process_group) before "
                           "a mesh")
    size = math.prod(shape)
    if dist.get_world_size() != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def fsdp_axis(mesh) -> str | None:
    return "data" if "data" in axis_names(mesh) else None


def tensor_axis(mesh) -> str | None:
    return "model" if "model" in axis_names(mesh) else None
