"""Mamba2 mixer — SSD (state-space duality) with chunked scan.

The chunked formulation splits the sequence into chunks of length Q:
intra-chunk terms are dense matmuls (the part kernel B4, ``ssd_chunk``,
computes when ``use_pallas_ssd`` routes there), the inter-chunk recurrence
is a short loop over Nc = S/Q chunk states. Decode is the O(1) recurrent
update h' = exp(dt·A)·h + dt·(B ⊗ x).

Layer layout (n_groups = 1), as in the JAX package's ``models/ssm.py``:
  in_proj (d, 2·d_inner + 2·N + H)  -> z, x, B, C, dt
  conv    depthwise causal width-4 over concat(x, B, C)
  A_log, dt_bias, D : (H,)
  norm    gated RMSNorm (d_inner,)
  out_proj (d_inner, d)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models import params as P_
from repro_torch.models import shard


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    heads: int
    head_dim: int
    state: int
    conv_width: int
    chunk: int
    use_pallas: bool = False

    @classmethod
    def from_cfg(cls, cfg):
        d_inner = cfg.ssm_expand * cfg.d_model
        heads = d_inner // cfg.ssm_head_dim
        return cls(cfg.d_model, d_inner, heads, cfg.ssm_head_dim,
                   cfg.ssm_state, cfg.conv_width, cfg.ssm_chunk,
                   cfg.use_pallas_ssd)

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.state

    @property
    def in_proj_dim(self):
        return 2 * self.d_inner + 2 * self.state + self.heads


def ssm_init(gen: torch.Generator, dims: SSMDims,
             dtype=torch.float32) -> Dict:
    dev = gen.device
    return {
        "in_proj": P_.dense_init(gen, dims.d_model,
                                 (dims.d_model, dims.in_proj_dim), dtype),
        **layers.causal_conv1d_init(gen, dims.conv_dim, dims.conv_width,
                                    dtype),
        "A_log": torch.zeros((dims.heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((dims.heads,), dtype=torch.float32,
                               device=dev),
        "D": torch.ones((dims.heads,), dtype=torch.float32, device=dev),
        "norm": torch.ones((dims.d_inner,), dtype=dtype, device=dev),
        "out_proj": P_.dense_init(gen, dims.d_inner,
                                  (dims.d_inner, dims.d_model), dtype),
    }


def _split_proj(p: Dict, u: torch.Tensor, dims: SSMDims):
    zx = u @ p["in_proj"].to(u.dtype)
    return torch.split(zx, [dims.d_inner, dims.d_inner, dims.state,
                            dims.state, dims.heads], dim=-1)


def _gated_norm(p: Dict, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps)
            * p["norm"].to(torch.float32)).to(y.dtype)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular pairwise cumulative sums."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    # element (i, j): sum_{j < m <= i} x_m  for i >= j; diag = 0
    d = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(tril, d, -torch.inf)


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xdt (b,s,h,p) = dt·x;  dA (b,s,h);  B,C (b,s,n).

    Returns (y (b,s,h,p), final_state (b,h,p,n)). The reference's 4-operand
    einsum is contracted as C·Bᵀ, then ⊙L, then ·x, so no (b,c,q,k,h,p)
    intermediate is built. ``DTensor`` inputs scan replicated, every head
    on every rank (``kernels.ops.sharded_ssd``).
    """
    if any(shard.is_dtensor(t) for t in (xdt, dA, Bc, Cc, h0)):
        return kops.sharded_ssd(ssd_scan, xdt, dA, Bc, Cc, chunk, h0)
    b, s, h, pdim = xdt.shape
    n = Bc.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        # zero-pad the tail: xdt=0 contributes nothing and dA=0 -> decay 1,
        # so y[:s] and the final state are exact
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // Q
    xc = xdt.reshape(b, nc, Q, h, pdim)
    dAc = dA.reshape(b, nc, Q, h)
    Bq = Bc.reshape(b, nc, Q, n)
    Cq = Cc.reshape(b, nc, Q, n)
    dt = xdt.dtype

    dA_cs = torch.cumsum(dAc, dim=2)                                 # (b,c,Q,h)
    L = torch.exp(segsum(torch.movedim(dAc, -1, -2)))                # (b,c,h,Q,Q)
    # intra-chunk (kernel B4 computes this fused on the card)
    G = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)                      # (b,c,Q,Q)
    M = G[:, :, None] * L.to(dt)                                     # (b,c,h,Q,Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)
    # per-chunk input -> end-of-chunk state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)            # (b,c,Q,h)
    states = torch.einsum("bckn,bckhp->bchpn", Bq,
                          xc * decay_states.to(dt)[..., None])       # (b,c,h,p,n)
    # inter-chunk recurrence; emit the state *entering* each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                      # (b,c,h)
    carry = (torch.zeros((b, h, pdim, n), dtype=dt, device=xdt.device)
             if h0 is None else h0)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = states[:, c] + chunk_decay[:, c, :, None, None].to(
            carry.dtype) * carry
    prev_states = torch.stack(prev, dim=1)                           # (b,c,h,p,n)
    # contribution of the incoming state to each position
    state_decay = torch.exp(dA_cs)                                   # (b,c,Q,h)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cq, prev_states)
             * state_decay.to(dt)[..., None])
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    if pad:
        y = y[:, :s_orig]
    return y, carry


class SSMCache(NamedTuple):
    conv_buf: torch.Tensor     # (B, width-1, conv_dim)
    state: torch.Tensor        # (B, H, P, N)


def init_ssm_cache(batch: int, dims: SSMDims, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    return SSMCache(
        conv_buf=torch.zeros((batch, dims.conv_width - 1, dims.conv_dim),
                             dtype=dtype, device=device),
        state=torch.zeros((batch, dims.heads, dims.head_dim, dims.state),
                          dtype=dtype, device=device),
    )


def ssm_forward(p: Dict, u: torch.Tensor, dims: SSMDims,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence mixer. u: (B, S, d) -> (y (B, S, d), final_state)."""
    z, x, Bc, Cc, dt = _split_proj(p, u, dims)
    xbc = torch.cat([x, Bc, Cc], dim=-1)
    xbc = F.silu(layers.causal_conv1d(p, xbc))
    x, Bc, Cc = torch.split(xbc, [dims.d_inner, dims.state, dims.state],
                            dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,S,H)
    A = -torch.exp(p["A_log"])                                       # (H,)
    xh = x.reshape(*x.shape[:-1], dims.heads, dims.head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    dA = dt * A
    s = xdt.shape[1]
    # the reference's shape rule: the kernel route needs s to divide by
    # min(chunk, s); any other length runs ssd_scan
    if dims.use_pallas and s % min(dims.chunk, s) == 0:
        if h0 is None:
            h0 = torch.zeros((xdt.shape[0], dims.heads, dims.head_dim,
                              dims.state), dtype=xdt.dtype, device=xdt.device)
        y, final = kops.ssd_chunked_ad(xdt, dA, Bc, Cc, dims.chunk, h0)
    else:
        y, final = ssd_scan(xdt, dA, Bc, Cc, dims.chunk, h0)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(*u.shape[:-1], dims.d_inner)
    y = _gated_norm(p, y, z)
    return y @ p["out_proj"].to(u.dtype), final


def ssm_decode_step(p: Dict, u_t: torch.Tensor, cache: SSMCache,
                    dims: SSMDims) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update. u_t: (B, d)."""
    z, x, Bc, Cc, dt = _split_proj(p, u_t, dims)
    xbc = torch.cat([x, Bc, Cc], dim=-1)
    xbc, conv_buf = layers.causal_conv1d_step(p, xbc, cache.conv_buf)
    xbc = F.silu(xbc)
    x, Bc, Cc = torch.split(xbc, [dims.d_inner, dims.state, dims.state],
                            dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                           # (B,H)
    xh = x.reshape(x.shape[0], dims.heads, dims.head_dim)
    dBx = torch.einsum("bn,bhp->bhpn", Bc, xh * dt[..., None].to(xh.dtype))
    sdt = cache.state.dtype
    state = cache.state * dA[..., None, None].to(sdt) + dBx.to(sdt)
    y = torch.einsum("bhpn,bn->bhp", state, Cc.to(sdt))
    y = y + p["D"].to(y.dtype)[:, None] * xh.to(y.dtype)
    y = y.reshape(u_t.shape[0], dims.d_inner).to(u_t.dtype)
    y = _gated_norm(p, y, z)
    out = y @ p["out_proj"].to(u_t.dtype)
    return out, SSMCache(conv_buf, state)
