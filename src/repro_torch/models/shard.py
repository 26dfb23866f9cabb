"""Tensor-parallel helpers on the ``model`` axis, and the opt-in activation
pins.

The port runs tensor parallelism with ``torch.distributed.tensor``: every
parameter is a ``DTensor`` on the 1-D ``model`` sub-mesh, placed by the
JAX package's rules (``models.params``). DTensor's sharding propagation
inserts the collectives of the plain ops (norms, residuals, the
replicated leaves); where it would gather a sharded axis or has no rule,
the model code computes on this rank's shard instead (attention's heads,
the MoE experts, the vocab-parallel embedding, the kernels), through
``unwrap``/``local_shard``, ``wrap``/``like`` and the conjugate sums
here.

The layout helpers (``enter``, ``leave``, ``replicate``, ``placed_as``,
``local``, ``like``, ``pointwise``, ``mesh_of``, ``context``) and the pins
pass a plain tensor through unchanged, so the same model code runs on one
device. ``unwrap``, ``local_shard``, ``wrap``, ``reduce_partial``,
``vocab_embedding`` and ``place`` take or make ``DTensor``s and are
called only on the tensor-parallel route. DTensor's module takes over a
second to import, so nothing here imports it before a caller has: no
``DTensor`` can exist until then (``is_dtensor``).

The pins (``enable``, ``heads``, ``last``) are the JAX package's
``models/shard.py``: with ``enable(True, mesh)`` the attention and MoE hot
spots redistribute their activations so that the heads (or expert
features) axis is sharded on ``model``. A pin applies only when it is
enabled, the tensor is a ``DTensor``, the registered mesh has a ``model``
axis and the pinned dimension divides it; otherwise ``x`` is returned
unchanged.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map

PyTree = Any

_ENABLED = False
_MESH = None


def enable(value: bool = True, mesh=None) -> None:
    global _ENABLED, _MESH
    _ENABLED = value
    if mesh is not None:
        _MESH = mesh


def enabled() -> bool:
    return _ENABLED


def model_axis_size() -> Optional[int]:
    if _MESH is None or "model" not in (_MESH.mesh_dim_names or ()):
        return None
    return _MESH.size(_MESH.mesh_dim_names.index("model"))


def heads(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pin the heads axis of (..., H, hd)-shaped activations to 'model'."""
    if not _ENABLED or _MESH is None or not is_dtensor(x):
        return x
    msize = model_axis_size()
    ax = axis % x.ndim
    if not msize or x.shape[ax] % msize:
        return x
    from torch.distributed.tensor import Shard
    return x.redistribute(x.device_mesh, [Shard(ax)])


def last(x: torch.Tensor) -> torch.Tensor:
    """Pin the last (feature) axis to 'model' (MoE expert-parallel h)."""
    return heads(x, axis=-1)


# ---------------------------------------------------------------------------
# helpers of the tensor-parallel path
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(tree: PyTree):
    """The mesh of the first ``DTensor`` leaf of ``tree``, or ``None``
    (a plain tree: no tensor parallelism)."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def context(mesh):
    """The context a tensor-parallel region runs in: plain tensors that
    meet a ``DTensor`` (a mask, a position table, a zero accumulator) count
    as replicated. A null context without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def enter(tree: PyTree, mesh) -> PyTree:
    """Activations entering a tensor-parallel region: every plain tensor
    leaf replicated on ``mesh`` (its local value is this rank's whole
    value). Without a mesh the tree as it is."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    return tree_map(lambda x: DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(x, torch.Tensor) and not is_dtensor(x) else x, tree)


def leave(tree: PyTree) -> PyTree:
    """Outputs leaving a tensor-parallel region: every ``DTensor`` leaf as
    a plain tensor holding its whole value."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on its mesh (a pending partial sum reduced, a shard
    gathered); a plain tensor as it is."""
    if is_dtensor(x) and any(not p.is_replicate() for p in x.placements):
        from torch.distributed.tensor import Replicate
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


def placed_as(g, ref):
    """A gradient ``g`` laid out as the tensor ``ref`` it was taken to: a
    replicated input's gradient comes back from DTensor's autograd as a
    pending partial sum, which this reduces (differentiably). ``g`` as it
    is when both are plain or already alike (or ``g`` is ``None``)."""
    if not is_dtensor(g) or not is_dtensor(ref) \
            or g.placements == ref.placements:
        return g
    return g.redistribute(ref.device_mesh, ref.placements)


def local(x):
    """This rank's shard of ``x`` (``x`` itself when plain)."""
    return x.to_local() if is_dtensor(x) else x


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(x.contiguous(), "sum", (mesh, 0))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = funcol.wait_tensor(out)
    return out


class _Sum(torch.autograd.Function):
    """This rank's partial sum summed over ``mesh`` (one all-reduce); the
    gradient goes back to every rank whole, through ``_SumGrad``. The two
    are each other's backward (tensor parallelism's conjugate pair), so
    derivatives of any order stay consistent: a gradient that only part
    of the ranks' local math produced is summed exactly where a forward
    value was copied."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _SumGrad.apply(g, ctx.mesh), None


class _SumGrad(torch.autograd.Function):
    """The identity on this rank's copy of a replicated tensor whose
    backward sums the gradient over ``mesh`` (through ``_Sum``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.mesh), None


class _Wrap(torch.autograd.Function):
    """This rank's shard as a ``DTensor`` (``DTensor.from_local``), whose
    backward lays the incoming gradient out as the forward placement
    (DTensor's differentiable ``redistribute``) and unwraps it through
    ``_Unwrap``. The two are each other's backward, so derivatives of any
    order go through: DTensor's own ``from_local`` reduces a partial-sum
    gradient outside the autograd graph, and in some releases (2.11) its
    ``to_local`` hands back a gradient with no graph at all."""

    @staticmethod
    def forward(ctx, t, mesh, placement):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.placement = mesh, placement
        return DTensor.from_local(t, mesh, [placement], run_check=False)

    @staticmethod
    def backward(ctx, g):
        if g.placements[0] != ctx.placement:
            g = g.redistribute(ctx.mesh, [ctx.placement])
        return _Unwrap.apply(g), None, None


class _Unwrap(torch.autograd.Function):
    """A ``DTensor``'s local shard; its backward wraps the gradient back
    through ``_Wrap`` (see there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placement = x.device_mesh, x.placements[0]
        return x.to_local().view_as(x.to_local())

    @staticmethod
    def backward(ctx, g):
        return _Wrap.apply(g.contiguous(), ctx.mesh, ctx.placement)


def unwrap(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the ``DTensor`` ``x`` (a 1-D mesh), for math on
    the shard that autograd goes back through, to any order (``_Unwrap``);
    its gradient comes back contiguous."""
    return _Unwrap.apply(x)


def wrap(t: torch.Tensor, mesh, placement) -> torch.Tensor:
    """This rank's shard ``t`` (a plain tensor) as a ``DTensor`` placed as
    ``placement`` on the 1-D ``mesh``, differentiable to any order. Shards
    are even (the rules shard only dimensions that divide), so the whole
    shape and strides follow from ``t``'s."""
    return _Wrap.apply(t, mesh, placement)


def reduce_partial(t: torch.Tensor, mesh) -> torch.Tensor:
    """Each rank's partial sum ``t`` (a plain local tensor) summed over the
    1-D ``mesh``, as a replicated ``DTensor``; differentiable to any
    order."""
    from torch.distributed.tensor import Replicate
    return wrap(_Sum.apply(t, mesh), mesh, Replicate())


def local_shard(x: torch.Tensor, partial_grad: bool = False
                ) -> torch.Tensor:
    """``unwrap(x)``: this rank's shard, for math on it that autograd goes
    back through. ``partial_grad``: ``x`` is replicated and the math after
    reads only part of it on each rank, so its gradient is summed over the
    mesh (``_SumGrad``). DTensor's own
    ``to_local(grad_placements=[Partial()])`` would reduce it outside the
    autograd graph, and a second derivative would lose that path."""
    t = unwrap(x)
    return _SumGrad.apply(t, x.device_mesh) if partial_grad else t


def like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, this rank's shard of a tensor placed as ``ref``, wrapped back
    with ``ref``'s placement (``wrap``; ``t`` itself when ``ref`` is
    plain)."""
    if not is_dtensor(ref):
        return t
    return wrap(t, ref.device_mesh, ref.placements[0])


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """An elementwise ``fn`` of ``x`` computed on this rank's shard and
    placed as ``x`` (``fn(x)`` for a plain tensor): for ops DTensor has no
    sharding rule for."""
    return like(fn(unwrap(x)), x) if is_dtensor(x) else fn(x)


def vocab_embedding(table, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)`` on a ``DTensor`` table, replicated.
    On a vocab-sharded table (``Shard(0)``) each rank looks up the rows it
    holds, zeros elsewhere, and one all-reduce sums them: exact, as every
    row is nonzero on one rank only; its backward needs no collective."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard
    mesh = table.device_mesh
    if table.placements[0] != Shard(0):
        return replicate(F.embedding(enter(local(tokens), mesh).long(),
                                     replicate(table)))
    rows = unwrap(table)
    idx = local(tokens).long() - mesh.get_local_rank() * rows.shape[0]
    held = (idx >= 0) & (idx < rows.shape[0])
    out = F.embedding(torch.where(held, idx, 0), rows) * held[..., None]
    return reduce_partial(out.to(rows.dtype), mesh)


def place(x: torch.Tensor, mesh, placement) -> torch.Tensor:
    """A tensor every rank holds whole, placed on the 1-D ``mesh``: this
    rank cuts its own slice (no scatter)."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(placement, Shard):
        x = x.chunk(mesh.size(), placement.dim)[mesh.get_local_rank()]
        x = x.contiguous()
    return DTensor.from_local(x, mesh, [placement], run_check=False)
