"""Error feedback (EF) — paper Eq. 6, generic over any compressor.

The port of the JAX package's ``core/error_feedback.py``. EF keeps a
per-client residual ``e`` (the shape of the flat gradient). Each round the
client compresses ``u = g + e`` and keeps the part the compressor dropped:
``e' = u - decode(encode(u))``. The telescoped sum of reconstructions
equals the telescoped sum of true updates minus the final residual:

    sum_t recon_t = sum_t g_t + e_0 - e_T

so no gradient mass is lost, only delayed.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def ef_init(d: int, device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def ef_step(
    compress_fn: Callable[[torch.Tensor], Tuple[object, torch.Tensor]],
    g: torch.Tensor,
    e: torch.Tensor,
    enabled: bool = True,
) -> Tuple[object, torch.Tensor, torch.Tensor]:
    """One EF round. Returns (payload, recon, new_residual).

    With ``enabled=False`` the residual stays as it is (zero from
    ``ef_init``: the paper's w/o-EF ablation row).
    """
    u = g + e if enabled else g
    payload, recon = compress_fn(u)
    e_new = u - recon if enabled else e
    return payload, recon, e_new
