"""Baseline gradient compressors the paper compares against.

The port of the JAX package's ``core/baselines.py``. All operate on *flat*
float32 vectors (see ``flat.Flattener``) and return ``(payload, recon)``
where ``recon`` is the server-side reconstruction — exactly what the
decoder would produce from the payload. Budget accounting
(``payload_floats``) follows the paper's conventions:

* top-k (DGC):  k values + k indices  -> 2k float-equivalents
* rand-k:       k values + 1 seed     -> k + 1 (indices regenerable from seed)
* signSGD(+EF): 1 bit/coord + 1 scale -> d/32 + 1
* STC:          top-k + binarized values -> k (indices) + k/32 (signs) + 1 (mu)
* identity (FedAvg): d

These float counts are conventions, not measurements; the real wire format
lives in ``repro_torch.comm``, and ``compression_rate_bytes`` is the
bytes-based sibling of Eq. 1.

Top-k here is exact (``torch.topk``), as the reference's ``lax.top_k``;
the sampled-threshold select of kernel B6 is a separate front end
(``kernels.ops.topk_threshold`` + ``topk_mask``) that no compressor calls,
as in the reference. Signs are taken as the reference takes them, with
subnormals flushed to zero (``kernels.ftz``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ftz, ops


class Payload(NamedTuple):
    """Accounted-size stand-in, NOT the wire format. ``floats`` is the
    paper-convention payload size; the serialized frame is produced by
    ``repro_torch.comm.codec``."""

    data: tuple
    floats: float


def _clamp_k(k: int, n: int) -> int:
    return max(1, min(int(k), n))


def _scatter(vec: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """Zeros like ``vec`` with ``vals`` at ``idx``."""
    return torch.zeros_like(vec).index_put_((idx,), vals)


# ---------------------------------------------------------------------------
# identity (FedAvg)
# ---------------------------------------------------------------------------


def identity_compress(vec: torch.Tensor) -> Tuple[Payload, torch.Tensor]:
    return Payload((vec,), float(vec.numel())), vec


# ---------------------------------------------------------------------------
# top-k (DGC)
# ---------------------------------------------------------------------------


def topk_compress(vec: torch.Tensor, k: int) -> Tuple[Payload, torch.Tensor]:
    """Keep the k largest-magnitude coordinates (DGC sparsifier); tied
    magnitudes may be taken in another order than ``lax.top_k``'s."""
    k = _clamp_k(k, vec.numel())
    idx = torch.topk(torch.abs(vec), k).indices
    vals = vec[idx]
    return Payload((vals, idx), 2.0 * k), _scatter(vec, idx, vals)


# ---------------------------------------------------------------------------
# rand-k
# ---------------------------------------------------------------------------


def randk_compress(key, vec: torch.Tensor, k: int
                   ) -> Tuple[Payload, torch.Tensor]:
    """k coordinates drawn without replacement from ``key``, a
    ``torch.Generator`` on vec's device (or None: the default generator).
    A ``key`` that is an index tensor is used as the draw itself — the seam
    that lets tests start from the reference's index set."""
    if isinstance(key, torch.Tensor):
        idx = key.to(device=vec.device, dtype=torch.int64)
        k = idx.numel()
    else:
        k = _clamp_k(k, vec.numel())
        idx = torch.randperm(vec.numel(), generator=key,
                             device=vec.device)[:k]
    vals = vec[idx]
    return Payload((vals, idx), float(k) + 1.0), _scatter(vec, idx, vals)


# ---------------------------------------------------------------------------
# signSGD (with mean-|x| scale, as in EF-signSGD)
# ---------------------------------------------------------------------------


def signsgd_compress(vec: torch.Tensor) -> Tuple[Payload, torch.Tensor]:
    scale = torch.mean(torch.abs(vec))
    signs = ftz.sign(vec)
    # 0-sign coords reconstruct to 0 (sign(0) == 0): harmless and exact
    return Payload((signs, scale), vec.numel() / 32.0 + 1.0), scale * signs


# ---------------------------------------------------------------------------
# STC: sparse ternary compression = top-k + binarize kept values to mean
# ---------------------------------------------------------------------------


def stc_compress(vec: torch.Tensor, k: int) -> Tuple[Payload, torch.Tensor]:
    k = _clamp_k(k, vec.numel())
    idx = torch.topk(torch.abs(vec), k).indices
    vals = vec[idx]
    mu = torch.mean(torch.abs(vals))
    signs = ftz.sign(vals)
    return (Payload((signs, idx, mu), k + k / 32.0 + 1.0),
            _scatter(vec, idx, mu * signs))


# ---------------------------------------------------------------------------
# reconstruction quality (fused single-pass accounting)
# ---------------------------------------------------------------------------


def reconstruction_stats(vec: torch.Tensor, recon: torch.Tensor,
                         eps: float = 1e-12
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cosine, relative L2 error) of a reconstruction in two passes.

    The cosine is scalar algebra on the ``(⟨r,v⟩, ‖r‖², ‖v‖²)`` triple of
    one B1 launch (``ops.fused_cosine``). The error is not derived from
    that triple — ``‖r−v‖² = ‖r‖² − 2⟨r,v⟩ + ‖v‖²`` cancels
    catastrophically in f32 once the error drops below ~3e-4 relative — but
    from a direct sum over the difference.
    """
    d, rr, vv = ops.fused_cosine(recon, vec)
    cos = d / (torch.sqrt(rr) * torch.sqrt(vv) + eps)
    sq = torch.sum(torch.square(recon.to(torch.float32)
                                - vec.to(torch.float32)))
    return cos, torch.sqrt(sq) / (torch.sqrt(vv) + eps)


# ---------------------------------------------------------------------------
# budget helpers
# ---------------------------------------------------------------------------


def keep_k_for_budget(d: int, budget_floats: float) -> int:
    """k such that a top-k payload (2k floats) fits the budget."""
    return max(1, int(budget_floats // 2))


def compression_rate(payload_floats: float, d: int) -> float:
    """Paper Eq. 1: compressed size / uncompressed size (accounted floats)."""
    return payload_floats / float(d)


def compression_rate_bytes(payload_bytes: float, d: int,
                           bytes_per_param: int = 4) -> float:
    """Eq. 1 on measured wire bytes: encoded frame size (header included)
    over the raw f32 tree size."""
    return payload_bytes / (bytes_per_param * float(d))
