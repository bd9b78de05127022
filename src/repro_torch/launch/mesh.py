"""Device meshes over the initialised ``torch.distributed`` world.

Port of ``repro.launch.mesh``.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names (``pod``, ``data``, ``model``).  JAX
enumerates its devices itself; torch has no such view, so the world must
be initialised first (``torch.distributed.init_process_group`` with its
address, world size and rank), and a mesh covers all of it.  The device
type defaults to the card (``"cuda"``); the CPU tests pass ``"cpu"``.

Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist


def _world_size() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised torch.distributed world: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first"
        )
    return dist.get_world_size()


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole world
    (row-major over the ranks, as ``jax.make_mesh`` lays out devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    n = _world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks; the world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device_type)


def make_elastic_mesh(
    n_devices: Optional[int] = None, model_parallelism: int = 1, device_type: str = "cuda"
):
    """Best-effort mesh over whatever ranks survive (elastic rebuild):
    ``model_parallelism`` kept where it divides, the rest data parallel."""
    n = n_devices or _world_size()
    if n % model_parallelism != 0:
        model_parallelism = 1
    return make_mesh_compat((n // model_parallelism, model_parallelism), ("data", "model"),
                            device_type)


def smoke_mesh(device_type: str = "cuda"):
    """1x1 mesh (same axis names as production) for a one-rank world."""
    return make_mesh_compat((1, 1), ("data", "model"), device_type)


def axis_size(mesh, axis: str) -> int:
    """Size of the named axis of a ``DeviceMesh``, or of any object whose
    ``shape`` maps axis names to sizes (a ``jax.sharding.Mesh``, a stub)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        if axis not in names:
            raise KeyError(f"mesh has no axis {axis!r}; its axes are {tuple(names)}")
        return int(mesh.size(names.index(axis)))
    return int(mesh.shape[axis])


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping-shaped mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(a): int(s) for a, s in zip(names, mesh.shape)}
    return {str(a): int(s) for a, s in dict(mesh.shape).items()}
