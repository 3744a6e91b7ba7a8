"""Device meshes over ``torch.distributed``.

The port of the reference package's ``repro.launch.mesh``: a
``DeviceMesh`` stands for ``jax.make_mesh``.  A mesh spans the ranks of
the default process group, one device each, so the group must exist and
hold exactly the mesh's ranks: the caller starts it (``torchrun``, or
``torch.distributed.init_process_group`` with its address, world size and
rank).  The one exception mirrors jax's implicit local devices: a 1 x 1
host mesh with no group starts a one-rank group itself (NCCL for
``cuda``, gloo for ``cpu``) over an in-process store.

``set_mesh`` makes a mesh current (``jax.set_mesh``), so that code given
only an axis name (``optim.compression.psum_int8``) can find its ranks.

Meshes default to ``cuda``.  Building one never touches a device until it
is called, so importing this module is free.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_CURRENT: list = []


def _mesh(shape, names, device_type: str):
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs {n} ranks and no "
            "process group is initialized: start one with its address, "
            "world size and rank first")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"need {n} ranks for a {dict(zip(names, shape))} "
                           f"mesh, the process group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod: (pod=2, data=16, model=16) = 512 devices across 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def start_local_group(device_type: str = "cuda"):
    """A one-rank process group over an in-process store (NCCL for
    ``cuda``, gloo for ``cpu``); the caller destroys it
    (``torch.distributed.destroy_process_group``)."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the process group's ranks (tests / smoke
    runs).  A 1 x 1 mesh with no group starts a one-rank group itself
    (:func:`start_local_group`)."""
    if data * model == 1 and not dist.is_initialized():
        start_local_group(device_type)
    return _mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def set_mesh(mesh):
    """``jax.set_mesh``: ``mesh`` is :func:`current_mesh` inside."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost mesh of :func:`set_mesh`; raises outside one."""
    if not _CURRENT:
        raise RuntimeError("no current mesh: run inside `with "
                           "set_mesh(mesh):`")
    return _CURRENT[-1]
