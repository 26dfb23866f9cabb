"""Device meshes over ``torch.distributed`` ranks. Functions only: importing
this module never initialises a process group.

The port runs SPMD over processes, one rank per device (``torchrun``, or
processes spawned with ``RANK``/``WORLD_SIZE`` and a store). A JAX ``Mesh``
maps onto a ``torch.distributed.device_mesh.DeviceMesh`` with the same axis
names: ``"data"`` and ``"model"``, and ``"pod"`` for the production mesh.
The FL client dimension is sharded over ``client_axes(mesh)``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world_size() -> int:
    """Ranks in the job: the default process group's size once it exists,
    else ``WORLD_SIZE`` as a launcher (``torchrun``) exports it, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_rank() -> int:
    """This process's rank: the default process group's once it exists,
    else ``RANK`` as a launcher exports it, else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def ensure_process_group(device, backend: Optional[str] = None) -> None:
    """Initialise the default process group from the launcher's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)
    unless one exists; ``backend=None`` means NCCL for CUDA and gloo for
    the CPU."""
    if not dist.is_initialized():
        dist.init_process_group(
            backend or DEFAULT_BACKENDS[torch.device(device).type],
            init_method="env://")


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production shapes and names: 16x16 = 256 ranks a
    pod, 2 pods = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_process_group(device)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device="cuda",
                   backend: Optional[str] = None) -> DeviceMesh:
    """A ``(data = n // model, model)`` mesh over the job's n ranks (tests,
    examples, the trainer). ``backend`` applies only when this call
    initialises the process group."""
    n = world_size()
    if model < 1 or n % model != 0:
        raise ValueError(
            f"make_host_mesh: {n} device(s) cannot be split into a "
            f"(data={n}//{model}, model={model}) mesh — n % model must be 0 "
            f"(a truncated mesh would silently drop devices)")
    ensure_process_group(device, backend)
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def _sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def client_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes the FL client dimension is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def num_clients_for(mesh: DeviceMesh) -> int:
    sizes = _sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)
