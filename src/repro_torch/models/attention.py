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

Causal self-attention (``attention`` and ``models/mla.py``'s ``mla``) goes
through ``causal_self_attention``, which takes one of two routes by what it
can observe in its operands: kernel B7 (``kernels/causal_attention.py``,
the same arithmetic with the logits kept on chip) for CUDA tensors that
are not ``DTensor``s, in bf16, with head dimensions the kernel is built
for, no window and at least a tile (``flash.TILE``) of positions, outside
``flash.second_order()``; ``_sdpa`` with ``causal_mask`` for everything
else (the CPU, f32, tensor parallelism, a window, short sequences, and
the forwards of the 3SFC and FedSynth encoders' objectives, which run
inside ``second_order()`` since the kernel takes no second derivative).
Counters ``attention.kernel`` and
``attention.plain`` (``obs.layer_count``) count the calls of each route,
and each ``attention`` call is one ``attention`` span (``obs.layer_span``),
the remat's recompute included, not the backward.

The decode cache is a ring buffer of ``cache_len`` slots holding (k, v,
absolute position), a position of -1 marking an empty slot: ``cache_len ==
seq_len`` is exact full attention, ``cache_len == window`` exact
sliding-window attention in O(window) memory.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import causal_attention as flash
from repro_torch.models import params as P_
from repro_torch.models import shard
from repro_torch.models.rope import apply_rope
from repro_torch.obs import layer_count, layer_span

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
    """``einsum('...sd,dhk->...shk', x, w)`` in x's dtype. A ``DTensor``
    ``w`` projects on each rank's slice (``_proj_tp``)."""
    if shard.is_dtensor(w):
        return _proj_tp(x, w)
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor, dtype=None) -> torch.Tensor:
    """``einsum('...hk,hkd->...d', o, wo.astype(dtype))``, o promoted with
    ``dtype`` (o's own by default) as JAX promotes it. A ``DTensor``
    ``wo`` contracts on each rank's slice (``_out_tp``)."""
    if shard.is_dtensor(wo):
        return _out_tp(o, wo, dtype)
    dt = torch.promote_types(o.dtype, dtype or o.dtype)
    h, k, d = wo.shape
    return o.to(dt).flatten(-2) @ wo.to(dt).reshape(h * k, d)


def _proj_tp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_proj`` with ``w`` placed on the model sub-mesh: the replicated x
    times this rank's slice of w (heads or head_dim), the result placed
    as that slice (its x gradient a partial sum); a replicated w gives a
    replicated result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = w.device_mesh
    x = shard.enter(x, mesh)
    pw = w.placements[0]
    sharded = isinstance(pw, Shard)
    xl = shard.local_shard(shard.replicate(x), partial_grad=sharded)
    y = _proj(xl, shard.local_shard(w))
    place = Shard(y.ndim - 3 + pw.dim) if sharded else Replicate()
    return shard.wrap(y, mesh, place)


def _out_tp(o: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """``_out`` with ``wo`` placed on the model sub-mesh: this rank's heads
    (or head_dim slice) of o against its slice of wo, the partial products
    summed by one all-reduce; a replicated wo contracts whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = wo.device_mesh
    o = shard.enter(o, mesh)
    pw = wo.placements[0]
    wl = shard.local_shard(wo)
    if not isinstance(pw, Shard):
        y = _out(shard.local_shard(shard.replicate(o)), wl, dtype)
        return shard.wrap(y, mesh, Replicate())
    dim = o.ndim - 2 + pw.dim                  # heads (0) or head_dim (1)
    if o.placements[0] == Shard(dim):
        ol = shard.local_shard(o)
    else:
        n = wl.shape[pw.dim]
        lo = mesh.get_local_rank() * n
        ol = shard.local_shard(shard.replicate(o), partial_grad=True)
        ol = ol.narrow(dim, lo, n)
    return shard.reduce_partial(_out(ol, wl, dtype), mesh)


def _project_qkv(p: Dict, x: torch.Tensor,
                 xkv: Optional[torch.Tensor] = None):
    xkv = x if xkv is None else xkv
    q, k, v = _proj(x, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if "bq" in p:
        dt = x.dtype
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    # opt-in pins (models.shard): heads on 'model', head_dim where the
    # heads do not divide it
    return tuple(_pin_heads(t) for t in (q, k, v))


def _pin_heads(t: torch.Tensor) -> torch.Tensor:
    if t.shape[-2] % (shard.model_axis_size() or 1) == 0:
        return shard.heads(t)
    return shard.heads(t, axis=-1)


def _scale(head_dim: int) -> float:
    """``1 / sqrt(f32(hd))`` in f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (.., Sq, H, hd), k/v (.., Sk, KV, hd): grouped attention, f32
    softmax. Under tensor parallelism (``DTensor`` inputs) it runs on each
    rank's local tensors (``_sdpa_tp``)."""
    if shard.is_dtensor(q) or shard.is_dtensor(k):
        return _sdpa_tp(q, k, v, mask)
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


def _sdpa_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``_sdpa`` on ``DTensor``s, each rank on its own query heads where q
    arrives sharded on heads: with k and v sharded on heads too (the KV
    heads divide the model axis), or replicated and cut to the KV heads
    its query heads read (a whole number of groups per rank, or one KV
    head); the output stays sharded on heads, with no collective. Any
    other layout (the head_dim fallback) is replicated first and attends
    whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (q if shard.is_dtensor(q) else k).device_mesh
    q, k, v = shard.enter((q, k, v), mesh)
    H, KV = q.shape[-2], k.shape[-2]
    G, m = H // KV, mesh.size()
    heads = Shard(q.ndim - 2)
    local_mask = None if mask is None else shard.local(mask)
    if q.placements[0] == heads:
        if k.placements[0] == v.placements[0] == Shard(k.ndim - 2):
            out = _sdpa(shard.local_shard(q), shard.local_shard(k),
                        shard.local_shard(v), local_mask)
            return shard.like(out.contiguous(), q)
        hl = H // m
        if KV == 1 or hl % G == 0:
            lo = mesh.get_local_rank() * hl // G if KV > 1 else 0
            n = max(hl // G, 1)
            kl, vl = (shard.local_shard(shard.replicate(t), partial_grad=True)
                      [..., lo:lo + n, :] for t in (k, v))
            out = _sdpa(shard.local_shard(q), kl, vl, local_mask)
            return shard.like(out.contiguous(), q)
    # every rank attends whole over whole inputs: the output, and the
    # inputs' gradients, are replicated
    out = _sdpa(*(shard.local_shard(shard.replicate(t)) for t in (q, k, v)),
                local_mask)
    return shard.wrap(out.contiguous(), mesh, Replicate())


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


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0) -> bool:
    """Whether causal self-attention over q (.., S, H, D), k, v takes
    kernel B7: CUDA tensors, none a ``DTensor``, all bf16 and (B, S, heads,
    dim), (D, DV) one of ``flash.PAIRS``, no window, as many keys as
    queries and at least ``flash.TILE`` of them, and no second derivative
    to come (outside ``flash.second_order()``)."""
    return (not flash.in_second_order()
            and q.device.type == "cuda"
            and not any(shard.is_dtensor(t) for t in (q, k, v))
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.dim() == k.dim() == v.dim() == 4
            and (q.shape[-1], v.shape[-1]) in flash.PAIRS
            and window == 0
            and q.shape[-3] == k.shape[-3] >= flash.TILE)


def causal_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """``_sdpa(q, k, v, causal_mask(S, S, window))``, through kernel B7
    where ``kernel_route`` holds (counter ``attention.kernel``), else
    through ``_sdpa`` itself (counter ``attention.plain``)."""
    if kernel_route(q, k, v, window):
        layer_count("attention.kernel", 1, q)
        return flash.causal_attention(q, k, v, _scale(q.shape[-1]))
    layer_count("attention.plain", 1, q)
    S = q.shape[-3]
    return _sdpa(q, k, v, causal_mask(S, k.shape[-3], window,
                                      device=q.device))


def attention(p: Dict, x: torch.Tensor, *, theta: float, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              xkv: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, d). Cross-attention: pass xkv,
    causal=False (no RoPE on either side)."""
    with layer_span("attention", x):
        S = x.shape[-2]
        q, k, v = _project_qkv(p, x, xkv)
        if positions is None:
            positions = torch.arange(S, device=x.device)
        if xkv is None:  # self-attention: rope on both
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
        if causal and xkv is None:
            return _out(causal_self_attention(q, k, v, window), p["wo"])
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


def _write_slot(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor
                ) -> torch.Tensor:
    """``buf.index_copy(1, slot, val)``; a placed cache is written on each
    rank's shard, ``val`` laid out as the cache first (DTensor has no
    sharding rule for ``index_copy`` in every release)."""
    if not shard.is_dtensor(buf):
        return buf.index_copy(1, slot, val)
    mesh = buf.device_mesh
    val = shard.enter(val, mesh)
    if val.placements != buf.placements:
        val = val.redistribute(mesh, buf.placements)
    return shard.like(shard.local(buf).index_copy(1, slot, shard.local(val)),
                      buf)


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
    kc = _write_slot(cache.k, slot, k.to(cache.k.dtype))
    vc = _write_slot(cache.v, slot, v.to(cache.v.dtype))
    pc = _write_slot(cache.pos, slot, tpos.expand(B, 1).contiguous())
    # grouped attention over the whole ring buffer, masked by validity
    # and the window
    valid = (pc >= 0) & (pc <= t)
    if window > 0:
        valid = valid & (pc > t - window)
    mask = valid[:, None, None, None, :]                 # (B, 1, 1, 1, L)
    out = _sdpa(q[:, None], kc, vc, mask)[:, 0]          # (B, H, hd)
    return _out(out, p["wo"], x_t.dtype), KVCache(kc, vc, pc)
