"""Server-side aggregation G(·) and global-model update (paper Eq. 3/4/6)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import flat

PyTree = Any


def aggregate(recons: PyTree, weights: Optional[torch.Tensor] = None
              ) -> PyTree:
    """G over the leading client axis: arithmetic mean or |D_i|-weighted."""
    if weights is None:
        return flat.tree_map(lambda x: torch.mean(x, dim=0), recons)
    w = weights / torch.sum(weights)

    def wmean(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sum(wb * x, dim=0)

    return flat.tree_map(wmean, recons)


def server_update(global_params: PyTree, agg_update: PyTree,
                  server_lr: float = 1.0, *, out: PyTree = None) -> PyTree:
    """w^{t+1} = w^t - lr * G(...). agg_update carries the paper's g sign.

    ``out``, a tree shaped as the params (the params themselves under a
    donated graph round, ``fl.round``), takes w^{t+1} in place and is
    returned: the same arithmetic, so bitwise the same values."""
    def new(p, u):
        return (p.to(torch.float32)
                - server_lr * u.to(torch.float32)).to(p.dtype)

    if out is None:
        return flat.tree_map(new, global_params, agg_update)

    def write(o, p, u):
        if p.dtype == o.dtype == torch.float32:
            # p - lr·u into o directly: the same two roundings, no copy
            torch.sub(p, server_lr * u.to(torch.float32), out=o)
        else:
            o.copy_(new(p, u))

    flat.tree_map(write, out, global_params, agg_update)
    return out
