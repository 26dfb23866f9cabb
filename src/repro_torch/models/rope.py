"""Rotary position embeddings (positions passed explicitly for decode).

The JAX package's ``models/rope.py``: the head dim's two halves are
rotated against each other (not interleaved pairs), the angles and the
rotation in f32, the result cast back to the input's dtype.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # theta as a device fill, never a host-to-device copy, so a CUDA graph
    # can capture it
    return 1.0 / (torch.full((), theta, dtype=torch.float32, device=device)
                  ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (.., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (.., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
