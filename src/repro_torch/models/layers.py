"""Shared primitive layers: RMSNorm, embedding, the logit projections, the
SwiGLU FFN, the depthwise causal conv of the LM families, and the paper
CNNs' conv2d.

Casts follow the JAX package's ``models/layers.py``: norm statistics and
logits in f32, the FFN's weights cast to the activation dtype at the call,
the conv in the activation dtype (its decode step in f32).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import params as P_
from repro_torch.models import shard

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
    if shard.is_dtensor(p["table"]):
        return shard.vocab_embedding(p["table"], tokens).to(dtype)
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
# SwiGLU FFN
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, d: int, ff: int,
             dtype=torch.float32) -> Dict:
    return {
        "w_in": P_.dense_init(gen, d, (d, ff), dtype),
        "w_gate": P_.dense_init(gen, d, (d, ff), dtype),
        "w_out": P_.dense_init(gen, ff, (ff, d), dtype),
    }


def ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``silu(x·w_gate) * (x·w_in)``, then ``w_out``."""
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    g = x @ p["w_gate"].to(dt)
    return (F.silu(g) * h) @ p["w_out"].to(dt)


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


# ---------------------------------------------------------------------------
# Conv2d (paper CNN models): HWIO weights, NHWC activations
# ---------------------------------------------------------------------------


def conv2d_init(gen: torch.Generator, cin: int, cout: int, k: int,
                dtype=torch.float32) -> Dict:
    w = P_.dense_init(gen, cin * k * k, (k, k, cin, cout), dtype)
    return {"w": w, "b": torch.zeros((cout,), dtype=dtype, device=w.device)}


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``(lo, hi)`` with ``lo =
    total // 2``, ``total = max((ceil(n/s) − 1)·s + k − n, 0)``. At stride 2
    it can be uneven, (0, 1) for k = 3 on an even size, which no symmetric
    ``padding=`` of ``F.conv2d`` gives."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` with dimension numbers (NHWC, HWIO,
    NHWC) and SAME or VALID padding, as one matrix product: the input's
    patches (``F.unfold``; a 1x1 conv's are the strided pixels) times the
    weights viewed as (kh·kw·cin, cout), f32 products summed in f32 (TF32
    off), the output NHWC as it comes. Its backward and double backward
    are products and ``F.fold``. cuDNN is not used: with TF32 off its
    backward for a 64->64 3x3 conv at 8x8 still misses f32 by 1e-3
    (``chip_smoke.py`` phase 15)."""
    w = p["w"].to(x.dtype)
    k_h, k_w, cin, cout = w.shape
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if k_h == k_w == 1:                     # SAME pads nothing at k = 1
        cols = x[:, ::stride, ::stride, :]
        return cols @ w.reshape(cin, cout) + p["b"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (ht, hb), (wl, wr) = (same_padding(x.shape[1], k_h, stride),
                              same_padding(x.shape[2], k_w, stride))
        if ht or hb or wl or wr:
            xc = F.pad(xc, (wl, wr, ht, hb))
    n, _, h, wd = xc.shape
    h_out, w_out = (h - k_h) // stride + 1, (wd - k_w) // stride + 1
    # (n, cin·kh·kw, L) with rows (c, i, j); the weights to match
    cols = F.unfold(xc, (k_h, k_w), stride=stride)
    wm = w.permute(2, 0, 1, 3).reshape(cin * k_h * k_w, cout)
    y = (cols.transpose(1, 2) @ wm).reshape(n, h_out, w_out, cout)
    return y + p["b"].to(x.dtype)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool at stride 2, VALID, over NHWC: the reference's
    ``reduce_window(max, (1, 2, 2, 1), (1, 2, 2, 1), 'VALID')``. A tie's
    gradient goes to the window's first maximum in row-major order, the
    element the reference's gradient picks."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
