"""Sign and threshold decisions under the reference's flush-to-zero.

The JAX package computes with f32 subnormals (|x| < 1.1755e-38) flushed to
zero: XLA's CPU runtime runs with FTZ/DAZ and a TPU has no subnormals. So
``jnp.sign(1e-40)`` is 0, ``-1e-40 >= 0`` is true (it compares as -0.0),
and a threshold below the smallest normal is 0. PyTorch does not flush, so
every sign or threshold decision on a subnormal would differ by a whole
scale or a whole bit. The port flushes explicitly at those decisions, and
only there: in sums, products and the EF update the flush moves a result
by at most ~1e-38, far inside every stated tolerance.
"""
from __future__ import annotations

import torch

# the smallest normal f32, 2**-126
FLT_MIN = torch.finfo(torch.float32).tiny


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal replaced by a zero of the same sign."""
    return torch.where(torch.abs(x) < FLT_MIN, x * 0, x)


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign`` as the reference computes it: subnormals flushed, and a
    zero keeps its sign (``torch.sign(-0.0)`` is +0.0, ``jnp.sign`` -0.0)."""
    f = flush_subnormal(x)
    return torch.where(f == 0, f, torch.sign(f))
