"""Tree <-> flat-vector utilities and tree algebra.

Compressors operate on trees of tensors (``repro_torch.core.tree``) or on
*flat* float32 vectors — the concatenation of every leaf. ``Flattener``
records shapes/dtypes once so flatten/unflatten round-trips are exact.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.tree import (PyTree, tree_flatten, tree_leaves,
                                   tree_map, tree_unflatten)
from repro_torch.kernels import ops


class Flattener:
    """Round-trippable tree <-> 1-D float32 vector mapping."""

    def __init__(self, tree: PyTree):
        leaves, treedef = tree_flatten(tree)
        self.treedef = treedef
        self.shapes: List[Tuple[int, ...]] = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [l.numel() for l in leaves]
        offsets = [0]
        for s in self.sizes:
            offsets.append(offsets[-1] + s)
        self.offsets = offsets
        self.total = offsets[-1]

    def flatten(self, tree: PyTree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def unflatten(self, vec: torch.Tensor) -> PyTree:
        leaves = [vec[off:off + size].reshape(shape).to(dtype)
                  for shape, dtype, off, size in zip(
                      self.shapes, self.dtypes, self.offsets[:-1], self.sizes)]
        return tree_unflatten(self.treedef, leaves)


# --- tree algebra --------------------------------------------------------------


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def _tree_stats_naive(a: PyTree, b: PyTree) -> torch.Tensor:
    """Single-traversal leafwise triple (a·b, ‖a‖², ‖b‖²), f32."""
    def leaf(x, y):
        xf = x.reshape(-1).to(torch.float32)
        yf = y.reshape(-1).to(torch.float32)
        return torch.stack([torch.sum(xf * yf), torch.sum(xf * xf),
                            torch.sum(yf * yf)])

    parts = tree_leaves(tree_map(leaf, a, b))
    return sum(parts) if parts else torch.zeros((3,), dtype=torch.float32)


def tree_stats(a: PyTree, b: PyTree) -> torch.Tensor:
    """(3,) f32 = [a·b, ‖a‖², ‖b‖²] over whole trees in one pass through
    kernel B1 (``kernels.ops.tree_fused_stats``). Differentiable to any
    order."""
    return ops.tree_fused_stats(a, b)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Sum of elementwise products over all leaves, accumulated in f32."""
    return tree_stats(a, b)[0]


def tree_sqnorm(a: PyTree) -> torch.Tensor:
    # Not routed through the pair kernel: a single-tree sum of squares is
    # already one pass; feeding a as both operands would read it twice.
    parts = [torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(a)]
    return sum(parts) if parts else torch.zeros((), dtype=torch.float32)


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(a))


def tree_cosine(a: PyTree, b: PyTree, eps: float = 1e-12) -> torch.Tensor:
    """cos(a, b) from the fused stats triple."""
    d, aa, bb = tree_stats(a, b)
    return d / (torch.sqrt(aa) * torch.sqrt(bb) + eps)


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_stack(trees) -> PyTree:
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_size(a: PyTree) -> int:
    """Total number of scalars in the tree (an empty leaf counts 1, as in
    the reference)."""
    return sum(l.numel() or 1 for l in tree_leaves(a))
