"""Parameter init helpers.

Params are nested dicts of tensors in the JAX package's layout (dense
weights ``(in, out)``; layer stacks with a leading layer axis), so the
reference's arrays load without transposes. Every draw comes from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, in_dim: int, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(in_dim)), truncated to ±2,
    drawn by inverting the normal CDF on the generator's device."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32) * (hi - lo) + lo
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    return (z / math.sqrt(max(in_dim, 1))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def stack_init(init_fn: Callable[[torch.Generator], PyTree],
               gen: torch.Generator, n: int) -> PyTree:
    """``init_fn`` for each of ``n`` layers, drawing from ``gen`` in turn,
    stacked leaf by leaf on a leading axis of size ``n``."""
    return stack_trees([init_fn(gen) for _ in range(n)])


def stack_trees(trees) -> PyTree:
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    flats = [tree_flatten(t) for t in trees]
    return tree_unflatten(flats[0][1], [torch.stack(leaves) for leaves in
                                        zip(*(f[0] for f in flats))])
