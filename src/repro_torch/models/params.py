"""Parameter init helpers.

Params are nested dicts of tensors in the JAX package's layout (dense
weights ``(in, out)``), so the reference's arrays load without transposes.
Every draw comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def dense_init(gen: torch.Generator, in_dim: int, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(in_dim)), truncated to ±2,
    drawn by inverting the normal CDF on the generator's device."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32) * (hi - lo) + lo
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    return (z / math.sqrt(max(in_dim, 1))).to(dtype)
