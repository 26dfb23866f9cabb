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
    if torch.device(device).type == "cuda" and dist.get_backend() == "gloo":
        route_gloo_cuda_collectives()
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def _sizes(mesh: DeviceMesh) -> dict:
    # sizes from the layout: ``mesh.mesh`` builds a tensor, which a fake
    # mode (a dry run) would refuse
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def client_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes the FL client dimension is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def num_clients_for(mesh: DeviceMesh) -> int:
    sizes = _sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)


def model_mesh(mesh: DeviceMesh) -> Optional[DeviceMesh]:
    """The 1-D ``model`` sub-mesh that tensor parallelism places parameters
    on; ``None`` for a mesh without a ``model`` axis."""
    if "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh["model"]


# ---------------------------------------------------------------------------
# gloo on CUDA tensors: the functional collectives routed through c10d
# ---------------------------------------------------------------------------
#
# Tensor parallelism's collectives are DTensor's functional ones
# (``torch.distributed._functional_collectives``). Ranks that share one
# card run over gloo (NCCL refuses two ranks on one device), and there,
# with torch 2.11 on CUDA tensors, the functional all-gather's wait
# crashes the process (a segmentation fault in ``wait_tensor``), and a
# functional all-reduce's result can be read on the current stream before
# gloo has copied it back (a 3SFC round's cosine came out halved), where
# c10d's blocking ``all_gather_into_tensor`` and ``all_reduce`` are
# right. So on a gloo group and a CUDA tensor every functional collective
# DTensor issues goes through c10d: the all-reduce through ``all_reduce``
# of a copy, the gathers through ``all_gather_into_tensor``, the
# reduce-scatters through ``all_reduce`` and this rank's chunk. Any other
# group or device takes the functional collective as it is.


def _group_of(group):
    """The process group of the ``(mesh, dim)`` pair DTensor names its
    collectives' group by; ``None`` for any other form (not routed)."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return None


def _gloo_cuda(t: torch.Tensor, pg) -> bool:
    return pg is not None and t.is_cuda and dist.get_backend(pg) == "gloo"


def _routed_gather(functional):
    def all_gather(self, gather_dim, group, tag=""):
        pg = _group_of(group)
        if not _gloo_cuda(self, pg):
            return functional(self, gather_dim, group, tag)
        n = dist.get_world_size(pg)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        return out if gather_dim == 0 else torch.cat(out.chunk(n),
                                                     dim=gather_dim)
    return all_gather


def _routed_scatter(functional):
    def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
        pg = _group_of(group)
        if not _gloo_cuda(self, pg):
            return functional(self, reduceOp, scatter_dim, group, tag)
        n = dist.get_world_size(pg)
        x = _reduce(self, reduceOp, pg)
        return x.chunk(n, dim=scatter_dim)[dist.get_rank(pg)].contiguous()
    return reduce_scatter


def _routed_reduce(functional):
    def all_reduce(self, reduceOp, group, tag=""):
        pg = _group_of(group)
        if not _gloo_cuda(self, pg):
            return functional(self, reduceOp, group, tag)
        return _reduce(self, reduceOp, pg)
    return all_reduce


def _reduce(x: torch.Tensor, op, pg) -> torch.Tensor:
    """The sum (or mean) of ``x`` over ``pg`` in a fresh tensor, blocking."""
    op = str(op).lower()
    if op not in ("sum", "avg"):
        raise NotImplementedError(f"reduction {op!r} on a gloo group of CUDA "
                                  f"tensors")
    x = x.contiguous().clone()
    dist.all_reduce(x, group=pg)
    return x / dist.get_world_size(pg) if op == "avg" else x


def route_gloo_cuda_collectives() -> None:
    """Route the functional all-gathers and reduce-scatters of a gloo
    group on CUDA tensors through c10d (see above). Idempotent."""
    import torch.distributed._functional_collectives as funcol
    if getattr(funcol, "_repro_torch_gloo_cuda", False):
        return
    for name in ("all_gather_tensor", "all_gather_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, _routed_gather(getattr(funcol, name)))
    for name in ("reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, _routed_scatter(getattr(funcol, name)))
    funcol.all_reduce = _routed_reduce(funcol.all_reduce)
    funcol._repro_torch_gloo_cuda = True
