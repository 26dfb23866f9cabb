"""Numpy bridge: trees of numpy arrays <-> the port's trees of tensors.

The port's tests turn the reference's arrays into numpy (``np.asarray``)
and load them here, so the port never sees a JAX type. Floating leaves
become f32 tensors; integer and boolean leaves keep their dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map

PyTree = Any


def params_from_numpy(tree: PyTree, device) -> PyTree:
    """Tree of numpy arrays -> tree of tensors on ``device``."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        # a fresh, writable, contiguous copy that keeps 0-d leaves 0-d
        return torch.as_tensor(np.array(a), device=device)
    return tree_map(leaf, tree)


def to_numpy(tree: PyTree) -> PyTree:
    """Tree of tensors -> tree of numpy arrays on the host; leaves that are
    not tensors (a state's round counter) pass through."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)
