"""Client-side local training: K SGD steps.

``local_train`` consumes a per-round batch tree with leading axis K (one
entry per local step). Each local step optionally splits its batch into
``num_micro`` gradient-accumulation slices.

Returns ``g = w_global - w_local`` — the accumulated update with the
paper's sign convention (Eq. 3: the server SUBTRACTS the aggregate).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import flat
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.models import shard

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], torch.Tensor]


def _value_and_grad(loss_fn: LossFn, params: PyTree, batch: PyTree
                    ) -> Tuple[torch.Tensor, PyTree]:
    leaves, treedef = tree_flatten(params)
    w = [p.detach().requires_grad_(True) for p in leaves]
    v = loss_fn(tree_unflatten(treedef, w), batch)
    grads = torch.autograd.grad(v, w)
    return v.detach(), tree_unflatten(treedef, [
        shard.placed_as(g, p) for g, p in zip(grads, w)])


def _grad_microbatched(loss_fn: LossFn, params: PyTree, batch: PyTree,
                       num_micro: int) -> Tuple[torch.Tensor, PyTree]:
    """value_and_grad, optionally accumulated over leading-dim slices.

    The accumulator starts from f32 zeros, as the reference's does, so the
    grads come back f32 whatever the parameters' dtype."""
    if num_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    mb = tree_leaves(batch)[0].shape[0] // num_micro
    acc = flat.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    tot = torch.zeros((), dtype=torch.float32,
                      device=tree_leaves(params)[0].device)
    for i in range(num_micro):
        sl = flat.tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
        v, g = _value_and_grad(loss_fn, params, sl)
        tot = tot + v
        acc = flat.tree_add(acc, g)
    scale = 1.0 / num_micro
    return tot * scale, flat.tree_scale(acc, scale)


def local_train(
    loss_fn: LossFn,
    global_params: PyTree,
    batches: PyTree,                 # leading axis K
    lr: float,
    *,
    num_micro: int = 1,
) -> Tuple[PyTree, torch.Tensor]:
    """K local SGD steps from ``global_params``. Returns (g, mean_loss)."""
    k_steps = tree_leaves(batches)[0].shape[0]
    w = flat.tree_map(torch.Tensor.detach, global_params)
    losses = []
    for k in range(k_steps):
        batch = flat.tree_map(lambda x: x[k], batches)
        v, grads = _grad_microbatched(loss_fn, w, batch, num_micro)
        w = flat.tree_map(
            lambda p, gr: (p.to(torch.float32)
                           - lr * gr.to(torch.float32)).to(p.dtype),
            w, grads)
        losses.append(v)
    g = flat.tree_map(lambda a, b: (a.detach() - b).to(torch.float32),
                      global_params, w)          # w^t - w_i^t (paper sign)
    return g, torch.mean(torch.stack(losses))
