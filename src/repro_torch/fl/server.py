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
                  server_lr: float = 1.0) -> PyTree:
    """w^{t+1} = w^t - lr * G(...). agg_update carries the paper's g sign."""
    return flat.tree_map(
        lambda p, u: (p.to(torch.float32)
                      - server_lr * u.to(torch.float32)).to(p.dtype),
        global_params, agg_update)
