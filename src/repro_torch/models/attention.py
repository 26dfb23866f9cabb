"""GQA attention: full/sliding-window causal, cross-attention, ring-buffer
KV-cache decode.

The JAX package's ``models/attention.py``, in its weight layout:
  wq (d, H, hd)   wk/wv (d, KV, hd)   wo (H, hd, d)   [+ optional biases]

Query head ``h`` reads KV head ``h // G`` (G = H / KV, heads grouped
contiguously). The logits are the activation dtype's product, then cast to
f32 and scaled; masked logits are ``NEG_INF`` (a finite -1e30, as the
reference, so a fully masked row stays finite); the softmax runs in f32
and the probabilities are cast back to ``v``'s dtype. This is written out
with einsums, as the reference is: ``F.scaled_dot_product_attention``
would take the softmax in the activation dtype.

The decode cache is a ring buffer of ``cache_len`` slots holding (k, v,
absolute position), a position of -1 marking an empty slot: ``cache_len ==
seq_len`` is exact full attention, ``cache_len == window`` exact
sliding-window attention in O(window) memory.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import params as P_
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d: int, num_heads: int, num_kv: int,
              head_dim: int, qkv_bias: bool = False,
              dtype=torch.float32) -> Dict:
    p = {
        "wq": P_.dense_init(gen, d, (d, num_heads, head_dim), dtype),
        "wk": P_.dense_init(gen, d, (d, num_kv, head_dim), dtype),
        "wv": P_.dense_init(gen, d, (d, num_kv, head_dim), dtype),
        "wo": P_.dense_init(gen, num_heads * head_dim,
                            (num_heads, head_dim, d), dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((num_kv, head_dim), dtype=dtype, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('...sd,dhk->...shk', x, w)`` in x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor, dtype=None) -> torch.Tensor:
    """``einsum('...hk,hkd->...d', o, wo.astype(dtype))``, o promoted with
    ``dtype`` (o's own by default) as JAX promotes it."""
    dt = torch.promote_types(o.dtype, dtype or o.dtype)
    h, k, d = wo.shape
    return o.to(dt).flatten(-2) @ wo.to(dt).reshape(h * k, d)


def _project_qkv(p: Dict, x: torch.Tensor,
                 xkv: Optional[torch.Tensor] = None):
    xkv = x if xkv is None else xkv
    q, k, v = _proj(x, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if "bq" in p:
        dt = x.dtype
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return q, k, v


def _scale(head_dim: int) -> float:
    """``1 / sqrt(f32(hd))`` in f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (.., Sq, H, hd), k/v (.., Sk, KV, hd): grouped attention, f32
    softmax."""
    H, KV = q.shape[-2], k.shape[-2]
    G = H // KV
    lead = q.shape[:-3]
    q = q.reshape(*lead, q.shape[-3], KV, G, q.shape[-1])
    dt = torch.promote_types(q.dtype, k.dtype)     # a bf16 cache, f32 q
    logits = torch.einsum("...qgrk,...sgk->...grqs", q.to(dt),
                          k.to(dt)).to(torch.float32) * _scale(q.shape[-1])
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("...grqs,...sgk->...qgrk", probs, v)
    return out.reshape(*lead, out.shape[-4], H, out.shape[-1])


def causal_mask(sq: int, sk: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) bool mask. ``offset`` = absolute position of query 0 minus
    absolute position of key 0 (for chunked prefill)."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def attention(p: Dict, x: torch.Tensor, *, theta: float, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              xkv: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, d). Cross-attention: pass xkv,
    causal=False (no RoPE on either side)."""
    S = x.shape[-2]
    q, k, v = _project_qkv(p, x, xkv)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if xkv is None:  # self-attention: rope on both
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    mask = (causal_mask(S, k.shape[-3], window, device=x.device)
            if causal else None)
    return _out(_sdpa(q, k, v, mask), p["wo"])


# ---------------------------------------------------------------------------
# KV cache (ring buffer)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, cache_len, KV, hd)
    v: torch.Tensor       # (B, cache_len, KV, hd)
    pos: torch.Tensor     # (B, cache_len) int32 absolute positions, -1 = empty


def init_cache(batch: int, cache_len: int, num_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, cache_len, num_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32,
                       device=device),
    )


def prefill_cache(p: Dict, x: torch.Tensor, cache_len: int, *,
                  theta: float, window: int = 0
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Full self-attention over x and the populated cache. When ``cache_len
    < S`` only the trailing ``cache_len`` keys are kept, in ring slots
    ``pos % cache_len``, and with no window the prefill attention itself
    is windowed to ``cache_len``."""
    B, S = x.shape[0], x.shape[-2]
    q, k, v = _project_qkv(p, x)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    eff_window = window if window > 0 else (0 if cache_len >= S
                                            else cache_len)
    out = _sdpa(q, k, v, causal_mask(S, S, eff_window, device=x.device))
    y = _out(out, p["wo"])
    if cache_len >= S:
        pad = cache_len - S
        kc = torch.cat([k, k.new_zeros((B, pad, *k.shape[2:]))], dim=1)
        vc = torch.cat([v, v.new_zeros((B, pad, *v.shape[2:]))], dim=1)
        pc = torch.cat([positions, positions.new_full((pad,), -1)])
    else:
        kc, vc, pc = k[:, -cache_len:], v[:, -cache_len:], \
            positions[-cache_len:]
        # ring layout: slot = pos % cache_len (a permutation of the slots)
        order = torch.argsort(pc % cache_len)
        kc, vc, pc = kc[:, order], vc[:, order], pc[order]
    pc = pc.to(torch.int32).expand(B, cache_len).clone()
    return y, KVCache(kc, vc, pc)


def decode_attention(p: Dict, x_t: torch.Tensor, cache: KVCache, t, *,
                     theta: float, window: int = 0
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. x_t: (B, d); t: the new token's absolute position
    (an int). Returns (y_t (B, d), the new cache); the input cache is not
    written."""
    B = x_t.shape[0]
    cache_len = cache.k.shape[1]
    q, k, v = _project_qkv(p, x_t[:, None, :])          # (B, 1, ·, hd)
    t = int(t)
    tpos = torch.tensor([t], dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, tpos, theta)[:, 0]
    k = apply_rope(k, tpos, theta)
    slot = torch.tensor([t % cache_len], device=x_t.device)
    kc = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
    vc = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
    pc = cache.pos.index_copy(1, slot, tpos.expand(B, 1).contiguous())
    # grouped attention over the whole ring buffer, masked by validity
    # and the window
    valid = (pc >= 0) & (pc <= t)
    if window > 0:
        valid = valid & (pc > t - window)
    mask = valid[:, None, None, None, :]                 # (B, 1, 1, 1, L)
    out = _sdpa(q[:, None], kc, vc, mask)[:, 0]          # (B, H, hd)
    return _out(out, p["wo"], x_t.dtype), KVCache(kc, vc, pc)
