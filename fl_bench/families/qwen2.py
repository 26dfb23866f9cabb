"""Qwen2-family decoder (Qwen1.5): what the benchmark needs of it.

* ``program_config``: the configuration file's keys as the port's
  ``ModelConfig`` fields;
* ``param_specs``: every leaf of the port's tree (its layout: layers
  stacked on a leading axis under ``layers/0``) with the benchmark's own
  init, drawn by ``flb_data.make_weights``;
* ``Reference``: the plain forward and losses (RMSNorm, RoPE on the two
  halves of each head, multi-head attention with QKV bias and an f32
  softmax, SwiGLU, tied head), every product through ``flb_prec.Prec`` in
  the compute dtype, norms, softmax and logits in f32 as the
  configuration computes them;
* ``forward_flops``: the products a forward needs, causal attention at
  half of the full product.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flb_reference import rmsnorm

NEG_INF = -1e30


def dims(cfg: Dict) -> Dict[str, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "kv": cfg["num_key_value_heads"],
            "hd": cfg["assumed"].get("head_dim", d // h),
            "ff": cfg["intermediate_size"], "L": cfg["num_hidden_layers"],
            "V": cfg["vocab_size"]}


def program_config(cfg: Dict) -> Dict:
    m = dims(cfg)
    return dict(family="dense", num_layers=m["L"], d_model=m["d"],
                num_heads=m["h"], num_kv_heads=m["kv"], d_ff=m["ff"],
                vocab_size=m["V"], head_dim=m["hd"], qkv_bias=True,
                rope_theta=float(cfg["rope_theta"]),
                norm_eps=float(cfg["rms_norm_eps"]),
                tie_embeddings=bool(cfg["tie_word_embeddings"]),
                param_dtype=cfg["assumed"]["param_dtype"],
                dtype=cfg["assumed"]["compute_dtype"])


def param_specs(cfg: Dict):
    m = dims(cfg)
    L, d, h, kv, hd, ff = m["L"], m["d"], m["h"], m["kv"], m["hd"], m["ff"]
    a = "layers/0/attn/"
    f = "layers/0/ffn/"
    return [
        ("embed/table", (m["V"], d), ("normal", 0.02)),
        ("final_norm/scale", (d,), ("const", 1.0)),
        (a + "wq", (L, d, h, hd), ("fan_in", d)),
        (a + "wk", (L, d, kv, hd), ("fan_in", d)),
        (a + "wv", (L, d, kv, hd), ("fan_in", d)),
        (a + "wo", (L, h, hd, d), ("fan_in", h * hd)),
        (a + "bq", (L, h, hd), ("normal", 0.02)),
        (a + "bk", (L, kv, hd), ("normal", 0.02)),
        (a + "bv", (L, kv, hd), ("normal", 0.02)),
        (f + "w_in", (L, d, ff), ("fan_in", d)),
        (f + "w_gate", (L, d, ff), ("fan_in", d)),
        (f + "w_out", (L, ff, d), ("fan_in", ff)),
        ("layers/0/ln1/scale", (L, d), ("const", 1.0)),
        ("layers/0/ln2/scale", (L, d), ("const", 1.0)),
    ]


def forward_flops(cfg: Dict, tokens_per_seq: int, seqs: int) -> float:
    """Product FLOPs of one forward over ``seqs`` sequences."""
    m = dims(cfg)
    L, d, h, kv, hd, ff, V = (m[k] for k in ("L", "d", "h", "kv", "hd",
                                              "ff", "V"))
    per_token = 2 * (L * (d * h * hd + 2 * d * kv * hd + h * hd * d
                          + 3 * d * ff) + V * d)
    # QKᵀ and PV over the causal half: 2 products of 2·S²·h·hd, halved
    attn = L * 2 * tokens_per_seq ** 2 * h * hd
    return float(seqs * (tokens_per_seq * per_token + attn))


def syn_forward_flops(cfg: Dict, n: int, length: int, rank: int) -> float:
    """A forward at the synthetic shapes, the soft labels' product with
    it."""
    return forward_flops(cfg, length, n) + 2.0 * n * length * rank * \
        dims(cfg)["V"]


# --- the plain reference -----------------------------------------------------


def rope(x, theta):
    """x (B, S, H, hd): the two halves of each head rotated, in f32."""
    hd, S = x.shape[-1], x.shape[-3]
    exponent = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=x.device) / hd
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                device=x.device) ** exponent)
    ang = torch.arange(S, device=x.device).to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class Reference:
    def __init__(self, cfg: Dict, prec):
        self.m = dims(cfg)
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.prec = prec
        self.dt = prec.dtype

    def layers(self, p: Dict):
        keys = ["ln1/scale", "ln2/scale", "attn/wq", "attn/wk", "attn/wv",
                "attn/wo", "attn/bq", "attn/bk", "attn/bv", "ffn/w_in",
                "ffn/w_gate", "ffn/w_out"]
        per = [torch.unbind(p["layers/0/" + k]) for k in keys]
        return [dict(zip(keys, ts)) for ts in zip(*per)]

    def block(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        B, S, d = x.shape
        h, kv, hd = self.m["h"], self.m["kv"], self.m["hd"]
        mm = self.prec.mm
        z = rmsnorm(x, lp["ln1/scale"], self.eps)
        q = mm(z, lp["attn/wq"].reshape(d, h * hd)).view(B, S, h, hd)
        k = mm(z, lp["attn/wk"].reshape(d, kv * hd)).view(B, S, kv, hd)
        v = mm(z, lp["attn/wv"].reshape(d, kv * hd)).view(B, S, kv, hd)
        q = q + lp["attn/bq"].to(self.dt)
        k = k + lp["attn/bk"].to(self.dt)
        v = v + lp["attn/bv"].to(self.dt)
        q, k = rope(q, self.theta), rope(k, self.theta)
        rep = h // kv
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
        # 1/sqrt(hd) rounded to f32, as the configuration computes it
        scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
        logits = mm(qh, kh).to(torch.float32) * scale.item()
        causal = torch.ones((S, S), dtype=torch.bool,
                            device=x.device).tril()
        logits = torch.where(causal, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(self.dt)
        o = mm(probs, vh).permute(0, 2, 1, 3).reshape(B, S, h * hd)
        x = x + mm(o, lp["attn/wo"].reshape(h * hd, d))
        z = rmsnorm(x, lp["ln2/scale"], self.eps)
        hid = mm(z, lp["ffn/w_in"])
        gate = mm(z, lp["ffn/w_gate"])
        return x + mm(F.silu(gate) * hid, lp["ffn/w_out"])

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
