"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The JAX package's ``models/rglru.py``. Per channel:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = a^(c·r_t)   with a = sigmoid(a_param), c = 8
    h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The block is the Griffin recurrent block: linear in -> temporal conv
(width 4) -> RG-LRU -> gated (tanh-approximated GeLU, ``jax.nn.gelu``'s
default) linear out. The gates run in f32. The full sequence takes the
recurrence as a log-depth doubling scan over whole tensors (⌈log₂ S⌉
steps), the counterpart of the reference's ``associative_scan``; decode is
the O(1) update.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import params as P_
from repro_torch.models import shard

_C = 8.0


class RGLRUCache(NamedTuple):
    conv_buf: torch.Tensor     # (B, width-1, W)
    h: torch.Tensor            # (B, W) f32


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 as XLA evaluates it on the
    CPU: ``stop·step + start·(1 − step)`` with ``step = iota·f32(1/div)``,
    the first product taken into one fused multiply-add (here in f64,
    which is exact for the product of two f32 and rounds once), the last
    point ``stop`` itself."""
    f32 = np.float32
    s, e = f32(start), f32(stop)
    if num == 1:
        return torch.tensor([s])
    div = num - 1
    it = np.arange(div, dtype=f32)
    rc = f32(1) / f32(div)
    a = s * (f32(1) - it * rc)
    head = (it.astype(np.float64) * np.float64(e * rc)
            + a.astype(np.float64)).astype(f32)
    return torch.from_numpy(np.append(head, e).astype(f32))


def a_param_init(width: int) -> torch.Tensor:
    """``a_param``'s deterministic init, the reference's
    ``log(expm1(r / (1 − r)))``, r = linspace(0.9, 0.999)^(1/c), in f32 on
    the CPU. Meant to spread a = sigmoid(a_param)^c over ~[0.9, 0.999], as
    written it overflows ``expm1`` to +inf past r ≈ 0.989 and is ≥ 75
    elsewhere, so a = 1 on every channel; the port keeps the reference's
    numbers."""
    r = _linspace_f32(0.9, 0.999, width) ** (1.0 / _C)
    return torch.log(torch.expm1(r / (1 - r)))


def rglru_init(gen: torch.Generator, d: int, width: int,
               conv_width: int = 4, dtype=torch.float32) -> Dict:
    dev = gen.device
    return {
        "w_in": P_.dense_init(gen, d, (d, width), dtype),        # branch in
        "w_gate_lin": P_.dense_init(gen, d, (d, width), dtype),  # gate branch
        **layers.causal_conv1d_init(gen, width, conv_width, dtype),
        "w_gate_in": P_.dense_init(gen, width, (width, width), dtype),
        "b_gate_in": torch.zeros((width,), dtype=dtype, device=dev),
        "w_gate_a": P_.dense_init(gen, width, (width, width), dtype),
        "b_gate_a": torch.zeros((width,), dtype=dtype, device=dev),
        "a_param": a_param_init(width).to(dev),
        "w_y": P_.dense_init(gen, width, (width, d), dtype),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _lru_coeffs(p: Dict, x: torch.Tensor):
    """x: (..., W) conv output. Returns (a, gx), both f32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ p["w_gate_a"].to(torch.float32) + p["b_gate_a"])
    i = torch.sigmoid(xf @ p["w_gate_in"].to(torch.float32) + p["b_gate_in"])
    # elementwise on each shard: DTensor has no rule for logsigmoid's
    # backward
    log_a = _C * r * shard.pointwise(F.logsigmoid, p["a_param"])  # log a_t
    a = torch.exp(log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)
    return a, gx


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t over axis 1 from h_{-1} = 0: the inclusive
    scan of ``(a_l, b_l) ∘ (a_r, b_r) = (a_l·a_r, b_r + a_r·b_l)`` by
    doubling, each step combining every position with the one ``off``
    before it on shifted views of whole tensors."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(p: Dict, u: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, S, d) -> (y (B, S, d), final hidden (B, W) f32)."""
    dt = u.dtype
    x = u @ p["w_in"].to(dt)
    gate = _gelu(u @ p["w_gate_lin"].to(dt))
    x = layers.causal_conv1d(p, x)
    a, gx = _lru_coeffs(p, x)                                    # (B,S,W)
    if h0 is not None:
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                        gx[:, 1:]], dim=1)
    h = linear_scan(a, gx)
    y = h.to(dt) * gate
    return y @ p["w_y"].to(dt), h[:, -1, :]


def init_rglru_cache(batch: int, width: int, conv_width: int = 4,
                     dtype=torch.bfloat16, device=None) -> RGLRUCache:
    return RGLRUCache(
        conv_buf=torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                             device=device),
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
    )


def rglru_decode_step(p: Dict, u_t: torch.Tensor, cache: RGLRUCache
                      ) -> Tuple[torch.Tensor, RGLRUCache]:
    """u_t: (B, d)."""
    dt = u_t.dtype
    x = u_t @ p["w_in"].to(dt)
    gate = _gelu(u_t @ p["w_gate_lin"].to(dt))
    x, conv_buf = layers.causal_conv1d_step(p, x, cache.conv_buf)
    a, gx = _lru_coeffs(p, x)
    h = a * cache.h + gx
    y = h.to(dt) * gate
    return y @ p["w_y"].to(dt), RGLRUCache(conv_buf, h)
