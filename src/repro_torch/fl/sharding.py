"""Mesh placement for the FL round: where every FLState byte lives.

``make_fl_shardings(mesh)`` derives the one placement contract the round
engine, the round function and the trainer share, over the ranks of a
``DeviceMesh`` (``repro_torch.launch.mesh``):

* ``params`` — replicated: every rank holds the global model w^t, so the
  per-client local-SGD and encode region needs no collective to read it,
  and the server update runs on every rank, the same code on the same
  inputs (no broadcast). This is the reference's fan-out contract on any
  mesh (its width-matched (1, P) mesh included). Tensor parallelism is
  placed explicitly: ``place_params`` puts each leaf on the ``model``
  sub-mesh by the JAX package's rule for it
  (``models.params.sharding_specs``), a ``DTensor``, ``Shard(dim)`` where
  the spec names ``model``, ``Replicate()`` elsewhere, as the reference
  places params by rule in its entries' specs (``launch/specs.py``).
* ``client`` — leading axis sharded over ``client_axes(mesh)``: the N×d EF
  residual tree, the ``ClientPools`` and the per-round ``(N, K, B, ...)``
  batch trees carry the client dimension first. Rank r of the client
  group owns the contiguous block ``[r·N/P, (r+1)·N/P)`` of clients end to
  end (the tiling of the reference's ``P(axes)``): its EF rows never leave
  it inside a round.
* the round counter and the staleness ring buffer are replicated like the
  params (the buffer is server state, and its leading axis is the S slots,
  not clients).

``replicated`` and ``client`` name these as ``torch.distributed.tensor``
placements, one per mesh dimension; ``state`` is the ``FLState``-shaped
tree of them, and ``place_state`` / ``gather_state`` cut and gather
exactly the fields it places as ``client``. On the client axes the port
keeps every tensor a plain local tensor: a rank's share of a client tree
is its rows (``place_client_tree``). On the ``model`` axis
``place_params`` places each leaf (of the params, or with
``client_axis`` of the EF tree) from the whole tensor every rank holds,
each rank cutting its own slice (no scatter), and
``gather_params`` gathers them back whole (for comparisons and the end of
a run). An EF leaf is placed as its parameter, one dimension further
right: the client rows come first and are never sharded on ``model``.

The round's only collective on the client axes is ``all_gather_rows``
(the ``model`` axis's are DTensor's own, inserted by its sharding
propagation, as GSPMD's are in the reference): each rank packs its
clients' records into one ``uint8`` buffer (byte views of the tensors, so
the round trip is exact) and one ``all_gather_into_tensor`` lays them out
in client order. The call exists in every torch the port runs on; newer
releases deprecate it for ``all_gather_single``, and that warning is
silenced at the one call site. ``COLLECTIVES`` counts the collectives this
module issues and ``GATHERED_BYTES`` the bytes this rank put into them,
as the kernel wrappers count ``LAUNCHES``.

The client group: ``mesh.get_group("data")`` for one client axis; for the
production mesh's ``("pod", "data")`` the sub-mesh flattened into one
dimension (``DeviceMesh._flatten``, which caches the group in the root
mesh, so every call returns the same one).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch.mesh import client_axes, model_mesh
from repro_torch.models import params as params_lib
from repro_torch.models import shard

PyTree = Any

COLLECTIVES = 0          # collectives issued by all_gather_rows
GATHERED_BYTES = 0       # bytes this rank put into them


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def all_gather_rows(rows: Sequence[PyTree], group) -> PyTree:
    """One collective: this rank's ``rows`` (trees of one structure, shapes
    and dtypes, in client order) gathered from every rank of ``group``, in
    rank order, as one tree whose leaves are stacked on a new leading axis
    of ``len(rows)`` × the group's size. Each leaf is a fresh contiguous
    tensor holding the gathered bytes exactly: contiguous, so the server
    phase reduces over the same layout as the single-process round's
    stack, and aligned for its dtype; the byte buffer is freed on
    return."""
    global COLLECTIVES, GATHERED_BYTES
    leaves0, treedef = tree_flatten(rows[0])
    if any(isinstance(l, DTensor) for l in leaves0):
        # tensor parallel: gather the model shards, each rank its own, and
        # place the stacked leaves one dimension further right
        got = all_gather_rows([tree_map(shard.local, r) for r in rows],
                              group)
        return tree_unflatten(treedef, [
            _stacked_like(g, l) for g, l in zip(tree_flatten(got)[0],
                                                leaves0)])
    metas = [(l.shape, l.dtype, l.numel() * l.element_size())
             for l in leaves0]
    local = torch.stack([torch.cat([_as_bytes(l)
                                    for l in tree_flatten(r)[0]])
                         for r in rows])
    total = dist.get_world_size(group) * len(rows)
    out = torch.empty((total, local.shape[1]), dtype=torch.uint8,
                      device=local.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, local, group=group)
    COLLECTIVES += 1
    GATHERED_BYTES += local.numel()
    leaves, off = [], 0
    for shape, dtype, nb in metas:
        # clone: a fresh, aligned buffer for the dtype view
        leaves.append(out[:, off:off + nb].clone().view(dtype)
                      .reshape((total, *shape)))
        off += nb
    return tree_unflatten(treedef, leaves)


def _stacked_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, this rank's shard of ``ref``-placed leaves stacked on a new
    leading axis, as a ``DTensor`` (``t`` itself when ``ref`` is plain)."""
    if not isinstance(ref, DTensor):
        return t
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in ref.placements]
    return DTensor.from_local(t, ref.device_mesh, placements,
                              run_check=False)


def tp_mesh(mesh: DeviceMesh):
    """The ``model`` sub-mesh when it is larger than 1 (tensor parallelism
    on), else ``None``: on a model axis of 1 every leaf stays plain."""
    mm = model_mesh(mesh)
    return mm if mm is not None and mm.size() > 1 else None


def param_placements(params: PyTree, mesh: DeviceMesh,
                     client_axis=None) -> PyTree:
    """Each leaf's placement on the ``model`` sub-mesh, from its rule."""
    specs = params_lib.sharding_specs(params, mesh, client_axis=client_axis)
    return tree_map(params_lib.model_placement, specs)


def place_params(params: PyTree, mesh: DeviceMesh,
                 client_axis=None) -> PyTree:
    """``params`` (whole on every rank) placed on the ``model`` sub-mesh by
    the rules; the tree as it is when the model axis is 1. With
    ``client_axis`` the leaves carry a leading client axis (an EF tree),
    which stays unsharded on ``model``."""
    mm = tp_mesh(mesh)
    if mm is None:
        return params
    return tree_map(lambda x, p: shard.place(x, mm, p), params,
                    param_placements(params, mesh, client_axis))


def gather_params(tree: PyTree) -> PyTree:
    """``place_params`` undone: every ``DTensor`` leaf whole, as a plain
    tensor (one collective per sharded leaf). For tests and the end of a
    run."""
    return shard.leave(tree)


def _rows(tree: PyTree, lo: int, hi: int) -> PyTree:
    return tree_map(lambda x: x[lo:hi].clone(), tree)


@dataclasses.dataclass(frozen=True)
class FLShardings:
    """Placements for one mesh, derived once and threaded everywhere."""

    mesh: DeviceMesh
    axes: Tuple[str, ...]            # mesh axes carrying the client dim
    replicated: tuple                # params, the round counter, metrics
    client: tuple                    # leading-axis client sharding
    state: Any                       # FLState-shaped tree of placements
    group: Any                       # process group over the client axes

    @property
    def client_shards(self) -> int:
        """How many ways the client axis is split (mesh axis size product)."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        n = 1
        for a in self.axes:
            n *= int(sizes[a])
        return n

    @property
    def shard(self) -> int:
        """This rank's block of clients: its rank in the client group, so
        that the gather's rank order is client order."""
        return dist.get_rank(self.group)

    def local_clients(self, num_clients: int) -> range:
        """The global ids of the clients this rank owns."""
        self.check_divisible(num_clients)
        per = num_clients // self.client_shards
        return range(self.shard * per, (self.shard + 1) * per)

    # ---- placement -------------------------------------------------------
    def place_state(self, state):
        """A whole-N ``FLState`` placed by ``self.state``: each field placed
        as ``client`` (the EF tree) cut to this rank's rows, the replicated
        ones (params, round, the staleness buffer) as they are. Requires
        ``N % client_shards == 0``."""
        return type(state)(*(self.place_client_tree(x) if p == self.client
                             else x for x, p in zip(state, self.state)))

    def place_client_tree(self, tree: PyTree) -> PyTree:
        """This rank's rows of a leading-axis-N tree (ClientPools, stacked
        batches), as fresh tensors."""
        ids = self.local_clients(tree_flatten(tree)[0][0].shape[0])
        return _rows(tree, ids.start, ids.stop)

    # alias matching the ClientPools use site by name
    place_pools = place_client_tree

    def gather_state(self, state):
        """The whole ``(N, ...)`` EF tree on every rank: ``place_state``
        undone, one collective per field placed as ``client``. For tests
        and the end of a run, never inside a round."""
        return type(state)(*(self._gather(x) if p == self.client else x
                             for x, p in zip(state, self.state)))

    def _gather(self, tree: PyTree) -> PyTree:
        local = tree_flatten(tree)[0][0].shape[0]
        rows = [tree_map(lambda e: e[j], tree) for j in range(local)]
        return all_gather_rows(rows, self.group)

    def check_divisible(self, num_clients: int) -> None:
        if num_clients % self.client_shards != 0:
            sizes = {a: int(s) for a, s in zip(self.mesh.mesh_dim_names,
                                               self.mesh.mesh.shape)}
            raise ValueError(
                f"num_clients={num_clients} is not divisible by the mesh's "
                f"{self.client_shards} client shard(s) (axes {self.axes} of "
                f"mesh {sizes}); "
                f"pad or regroup clients so each device owns a whole slice")


def _client_group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten("_".join(axes)).get_group()


def make_fl_shardings(mesh: DeviceMesh) -> FLShardings:
    """Derive the FL placement contract from a mesh (see module docstring)."""
    from repro_torch.fl.round import FLState

    axes = client_axes(mesh)
    names = mesh.mesh_dim_names
    replicated = tuple(Replicate() for _ in names)
    client = tuple(Shard(0) if a in axes else Replicate() for a in names)
    return FLShardings(
        mesh=mesh,
        axes=axes,
        replicated=replicated,
        client=client,
        state=FLState(params=replicated, ef=client, round=replicated,
                      buf=replicated, buf_w=replicated),
        group=_client_group(mesh, axes),
    )
