"""Mamba-2 (SSD) decoder: what the benchmark needs of it.

The same four pieces as ``qwen2.py``. The reference's mixer follows the
Mamba-2 paper's layer (arXiv:2405.21060, ``mamba_ssm``'s ``Mamba2`` with
one group): in_proj to (z, x, B, C, dt), a depthwise causal conv of width
4 with bias over (x, B, C) and SiLU, dt = softplus(dt + dt_bias), A =
−exp(A_log), the chunked SSD scan (the intra-chunk products, the
end-of-chunk states, the recurrence over chunks, the incoming state's
contribution), the D skip, the gated RMSNorm of y · SiLU(z), out_proj;
pre-norm residual blocks and a tied head. It is the port's plain scan,
frozen: products in the compute dtype, decays in f32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flb_reference import rmsnorm


def dims(cfg: Dict) -> Dict[str, int]:
    s = cfg["ssm_defaults"]
    d = cfg["d_model"]
    d_inner = s["expand"] * d
    return {"d": d, "L": cfg["n_layer"], "di": d_inner,
            "H": d_inner // s["headdim"], "P": s["headdim"],
            "N": s["d_state"], "W": s["d_conv"], "Q": s["chunk_size"],
            "V": vocab_rows(cfg)}


def vocab_rows(cfg: Dict) -> int:
    """The embedding's rows: the vocabulary padded to its multiple."""
    v, m = cfg["vocab_size"], cfg["pad_vocab_size_multiple"]
    return -(-v // m) * m


def program_config(cfg: Dict) -> Dict:
    m = dims(cfg)
    return dict(family="ssm", num_layers=m["L"], d_model=m["d"],
                num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=m["V"],
                ssm_state=m["N"], ssm_expand=cfg["ssm_defaults"]["expand"],
                ssm_head_dim=m["P"], ssm_chunk=m["Q"], conv_width=m["W"],
                block_pattern=("ssm",),
                norm_eps=float(cfg["norm_epsilon"]),
                tie_embeddings=bool(cfg["tie_embeddings"]),
                param_dtype=cfg["assumed"]["param_dtype"],
                dtype=cfg["assumed"]["compute_dtype"])


def param_specs(cfg: Dict):
    m = dims(cfg)
    L, d, di, H, N, W = m["L"], m["d"], m["di"], m["H"], m["N"], m["W"]
    conv = di + 2 * N
    s = "layers/0/ssm/"
    return [
        ("embed/table", (m["V"], d), ("normal", 0.02)),
        ("final_norm/scale", (d,), ("const", 1.0)),
        ("layers/0/ln1/scale", (L, d), ("const", 1.0)),
        (s + "in_proj", (L, d, 2 * di + 2 * N + H), ("fan_in", d)),
        (s + "conv_w", (L, W, conv), ("fan_in", W)),
        (s + "conv_b", (L, conv), ("normal", 0.02)),
        (s + "A_log", (L, H), ("log_uniform", 1.0, 16.0)),
        (s + "dt_bias", (L, H), ("softplus_inv", 1e-3, 1e-1)),
        (s + "D", (L, H), ("const", 1.0)),
        (s + "norm", (L, di), ("const", 1.0)),
        (s + "out_proj", (L, di, d), ("fan_in", di)),
    ]


def forward_flops(cfg: Dict, tokens_per_seq: int, seqs: int) -> float:
    """Product FLOPs of one forward over ``seqs`` sequences: the
    projections, the conv, the SSD products (the intra-chunk C·Bᵀ and its
    product with x over the causal half of each chunk, the chunk states
    and the incoming states' contribution) and the tied head."""
    m = dims(cfg)
    L, d, di, H, P, N, W, Q, V = (m[k] for k in ("L", "d", "di", "H", "P",
                                                 "N", "W", "Q", "V"))
    S = tokens_per_seq
    q = min(Q, S)
    chunks = -(-S // q)
    proj = 2 * d * (2 * di + 2 * N + H) + 2 * di * d + 2 * W * (di + 2 * N)
    ssd = chunks * (q * q * N + q * q * H * P + 4 * q * N * H * P)
    per_seq = S * (L * proj + 2 * V * d) + L * ssd
    return float(seqs * per_seq)


def syn_forward_flops(cfg: Dict, n: int, length: int, rank: int) -> float:
    return forward_flops(cfg, length, n) + 2.0 * n * length * rank * \
        dims(cfg)["V"]


# --- the plain reference -----------------------------------------------------


def segsum(x: torch.Tensor) -> torch.Tensor:
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(tril, d, -torch.inf)


def ssd(xdt, dA, Bc, Cc, chunk):
    """xdt (b,s,h,p), dA (b,s,h), B, C (b,s,n) -> y (b,s,h,p)."""
    b, s, h, p = xdt.shape
    n = Bc.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    nc = (s + pad) // Q
    xc = xdt.reshape(b, nc, Q, h, p)
    dAc = dA.reshape(b, nc, Q, h)
    Bq = Bc.reshape(b, nc, Q, n)
    Cq = Cc.reshape(b, nc, Q, n)
    dt = xdt.dtype
    cs = torch.cumsum(dAc, dim=2)
    L = torch.exp(segsum(torch.movedim(dAc, -1, -2)))
    G = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)
    M = G[:, :, None] * L.to(dt)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)
    decay = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("bckn,bckhp->bchpn", Bq,
                          xc * decay.to(dt)[..., None])
    chunk_decay = torch.exp(cs[:, :, -1, :])
    carry = torch.zeros((b, h, p, n), dtype=dt, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = states[:, c] + chunk_decay[:, c, :, None, None].to(dt) * carry
    prev = torch.stack(prev, dim=1)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cq, prev)
             * torch.exp(cs).to(dt)[..., None])
    return (y_diag + y_off).reshape(b, s + pad, h, p)[:, :s]


class Reference:
    def __init__(self, cfg: Dict, prec):
        self.m = dims(cfg)
        self.eps = float(cfg["norm_epsilon"])
        self.gated_eps = float(cfg["gated_norm_epsilon"])
        self.prec = prec
        self.dt = prec.dtype

    def layers(self, p: Dict):
        keys = ["ln1/scale", "ssm/in_proj", "ssm/conv_w", "ssm/conv_b",
                "ssm/A_log", "ssm/dt_bias", "ssm/D", "ssm/norm",
                "ssm/out_proj"]
        per = [torch.unbind(p["layers/0/" + k]) for k in keys]
        return [dict(zip(keys, ts)) for ts in zip(*per)]

    def block(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        di, H, P, N, W = m["di"], m["H"], m["P"], m["N"], m["W"]
        u = rmsnorm(x, lp["ln1/scale"], self.eps)
        z, xs, Bc, Cc, dt = torch.split(self.prec.mm(u, lp["ssm/in_proj"]),
                                        [di, di, N, N, H], dim=-1)
        xbc = torch.cat([xs, Bc, Cc], dim=-1)
        S = xbc.shape[1]
        xp = F.pad(xbc, (0, 0, W - 1, 0))
        conv = torch.zeros_like(xbc)
        for i in range(W):
            conv = conv + xp[:, i:i + S, :] * lp["ssm/conv_w"][i].to(self.dt)
        xbc = F.silu(conv + lp["ssm/conv_b"].to(self.dt))
        xs, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
        dt = F.softplus(dt.to(torch.float32) + lp["ssm/dt_bias"])
        A = -torch.exp(lp["ssm/A_log"])
        xh = xs.reshape(*xs.shape[:-1], H, P)
        y = ssd(xh * dt[..., None].to(xh.dtype), dt * A, Bc, Cc, m["Q"])
        y = y + lp["ssm/D"].to(y.dtype)[:, None] * xh
        y = y.reshape(*u.shape[:-1], di)
        g = (y * F.silu(z)).to(torch.float32)
        var = torch.mean(g * g, dim=-1, keepdim=True)
        y = (g * torch.rsqrt(var + self.gated_eps)
             * lp["ssm/norm"].to(torch.float32)).to(y.dtype)
        return x + self.prec.mm(y, lp["ssm/out_proj"])

    def trunk(self, p: Dict, x: torch.Tensor, remat: bool) -> torch.Tensor:
        for lp in self.layers(p):
            if remat:
                x = checkpoint(self.block, lp, x, use_reentrant=False)
            else:
                x = self.block(lp, x)
        return rmsnorm(x, p["final_norm/scale"], self.eps)

    def embed(self, p: Dict, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, p["embed/table"]).to(self.dt)

    def logits(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        return h.to(torch.float32) @ p["embed/table"].to(torch.float32).T
