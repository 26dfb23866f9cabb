"""Shared primitive layers of the LM families: RMSNorm, embedding, the
logit projections and the depthwise causal conv.

Casts follow the JAX package's ``models/layers.py``: norm statistics and
logits in f32, the conv in the activation dtype (its decode step in f32).
The FFN and conv2d wait for the attention families (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import params as P_

# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Dict:
    return {"table": P_.embed_init(gen, vocab, d, dtype)}


def embed(p: Dict, tokens: torch.Tensor, dtype=torch.bfloat16
          ) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # without casting the whole table
    return F.embedding(tokens.long(), p["table"]).to(dtype)


def unembed(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits: x (.., d) @ table.T (d, V), f32."""
    return x.to(torch.float32) @ p["table"].to(torch.float32).T


def lm_head_init(gen: torch.Generator, d: int, vocab: int,
                 dtype=torch.float32) -> Dict:
    return {"w": P_.dense_init(gen, d, (d, vocab), dtype)}


def lm_head(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) @ p["w"].to(torch.float32)


# ---------------------------------------------------------------------------
# Depthwise causal conv over time (SSM / RG-LRU)
# ---------------------------------------------------------------------------


def causal_conv1d_init(gen: torch.Generator, channels: int, width: int,
                       dtype=torch.float32) -> Dict:
    w = P_.dense_init(gen, width, (width, channels), dtype)
    return {"conv_w": w,
            "conv_b": torch.zeros((channels,), dtype=dtype, device=w.device)}


def causal_conv1d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, S, C)."""
    width = p["conv_w"].shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s, :] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def causal_conv1d_step(p: Dict, x_t: torch.Tensor, buf: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, C); buf: (B, width-1, C) past inputs.

    Returns (y_t, new_buf).
    """
    full = torch.cat([buf, x_t[:, None, :]], dim=1)                # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full.to(torch.float32),
                     p["conv_w"].to(torch.float32))
    y = (y + p["conv_b"].to(torch.float32)).to(x_t.dtype)
    return y, full[:, 1:, :]
