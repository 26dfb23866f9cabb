"""DeepSeek-V3-family decoder (Moonlight-16B-A3B): what the benchmark needs
of it.

The same pieces as ``qwen2.py``. The reference follows the published
``deepseek_v3`` layer equations with no q compression (``q_lora_rank``
null), one routing group and an MoE layer after each of the
``first_k_dense_replace`` dense ones:

* multi-head latent attention in its plain, un-absorbed form: q to H
  heads of nope + rope dims; x to a kv latent of ``kv_lora_rank`` and one
  rope key of ``qk_rope_head_dim`` shared by all heads; the latent
  RMS-normed and projected to each head's nope key and value; RoPE on the
  rope dims, q·k over nope + rope (scale 1/sqrt(nope + rope)), v of
  ``v_head_dim``, causal f32 softmax, o_proj;
* the MoE layer: f32 sigmoid scores over the router's E experts, each
  token's k experts the top k of score + ``e_score_correction_bias``
  (descending, a tie to the lower index), weighted by their bare scores
  normalised over the k and times ``routed_scaling_factor``; no capacity.
  The experts held here (``n_routed_experts`` of them from
  ``deployment.held_expert_start``) each run their SwiGLU on the tokens
  that chose them, one expert at a time over the boolean-selected rows,
  their weighted outputs summed per token in f32; the absent experts'
  part is left out, as on the chip that holds these. The shared experts
  are one SwiGLU of ``n_shared_experts · moe_intermediate_size``;
* pre-norm residual blocks, untied head, f32 params, every product
  through ``flb_prec.Prec``, router, norms, softmax and logits in f32.

Departures from the source, each in the configuration's ``assumed``:
RoPE turns the two halves of the rope dims (the published weights store
interleaved pairs: the same model up to a fixed permutation of columns);
the selection bias is drawn from the seed and never updated (the
source's bias-update rule is a training heuristic); no auxiliary loss
(``seq_aux``'s complementary loss likewise).

``forward_flops`` counts the routed experts at the uniform expectation
of k · n / E held slots a token.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flb_reference import rmsnorm

NEG_INF = -1e30
# what this reference implements of the family's settings
SUPPORTED = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
             "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "norm_topk_prob": True, "moe_layer_freq": 1,
             "attention_bias": False, "tie_word_embeddings": False}


def dims(cfg: Dict) -> Dict:
    for key, want in SUPPORTED.items():
        if cfg[key] != want:
            raise ValueError(f"{key}={cfg[key]!r}: the reference implements "
                             f"{want!r}")
    dep = cfg["deployment"]
    return {"d": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "kv": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "vd": cfg["v_head_dim"],
            "ffd": cfg["intermediate_size"],
            "ff": cfg["moe_intermediate_size"],
            "E": dep["router_experts"], "n": cfg["n_routed_experts"],
            "lo": dep["held_expert_start"], "k": cfg["num_experts_per_tok"],
            "shared": cfg["n_shared_experts"], "L": cfg["num_hidden_layers"],
            "Ld": cfg["first_k_dense_replace"], "V": cfg["vocab_size"]}


def program_config(cfg: Dict) -> Dict:
    m = dims(cfg)
    return dict(family="moe", num_layers=m["L"], d_model=m["d"],
                num_heads=m["H"], num_kv_heads=cfg["num_key_value_heads"],
                d_ff=m["ff"], vocab_size=m["V"], num_experts=m["E"],
                experts_per_token=m["k"], shared_experts=m["shared"],
                block_pattern=("mla",), rope_theta=float(cfg["rope_theta"]),
                norm_eps=float(cfg["rms_norm_eps"]), tie_embeddings=False,
                kv_lora_rank=m["kv"], qk_nope_head_dim=m["nope"],
                qk_rope_head_dim=m["rope"], v_head_dim=m["vd"],
                first_dense_layers=m["Ld"], dense_d_ff=m["ffd"],
                router="sigmoid",
                routed_scaling_factor=float(cfg["routed_scaling_factor"]),
                held_experts=m["n"], held_expert_start=m["lo"],
                param_dtype=cfg["assumed"]["param_dtype"],
                dtype=cfg["assumed"]["compute_dtype"])


def _mla_specs(prefix: str, lead: tuple, m: Dict):
    d, H, kv, nope, rope, vd = (m[k] for k in ("d", "H", "kv", "nope",
                                               "rope", "vd"))
    return [
        (prefix + "ln1/scale", lead + (d,), ("const", 1.0)),
        (prefix + "ln2/scale", lead + (d,), ("const", 1.0)),
        (prefix + "mla/wq", lead + (d, H, nope + rope), ("fan_in", d)),
        (prefix + "mla/wkv_a", lead + (d, kv + rope), ("fan_in", d)),
        (prefix + "mla/kv_norm/scale", lead + (kv,), ("const", 1.0)),
        (prefix + "mla/wkv_b", lead + (kv, H, nope + vd), ("fan_in", kv)),
        (prefix + "mla/wo", lead + (H, vd, d), ("fan_in", H * vd)),
    ]


def param_specs(cfg: Dict):
    m = dims(cfg)
    d, ff, ffd, E, n, V = (m[k] for k in ("d", "ff", "ffd", "E", "n", "V"))
    fs = ff * m["shared"]
    Lm = (m["L"] - m["Ld"],)
    specs = [("embed/table", (V, d), ("normal", 0.02)),
             ("final_norm/scale", (d,), ("const", 1.0)),
             ("lm_head/w", (d, V), ("fan_in", d))]
    for i in range(m["Ld"]):
        f = f"lead/{i}/ffn/"
        specs += _mla_specs(f"lead/{i}/", (), m) + [
            (f + "w_in", (d, ffd), ("fan_in", d)),
            (f + "w_gate", (d, ffd), ("fan_in", d)),
            (f + "w_out", (ffd, d), ("fan_in", ffd))]
    e = "layers/0/moe/"
    return specs + _mla_specs("layers/0/", Lm, m) + [
        (e + "router", Lm + (d, E), ("fan_in", d)),
        (e + "score_bias", Lm + (E,), ("normal", 0.1)),
        (e + "w_in", Lm + (n, d, ff), ("fan_in", d)),
        (e + "w_gate", Lm + (n, d, ff), ("fan_in", d)),
        (e + "w_out", Lm + (n, ff, d), ("fan_in", ff)),
        (e + "shared/w_in", Lm + (d, fs), ("fan_in", d)),
        (e + "shared/w_gate", Lm + (d, fs), ("fan_in", d)),
        (e + "shared/w_out", Lm + (fs, d), ("fan_in", fs)),
    ]


def forward_flops(cfg: Dict, tokens_per_seq: int, seqs: int) -> float:
    """Product FLOPs of one forward over ``seqs`` sequences: the latent
    attention's projections, the dense FFN, the router, the shared
    experts, the held experts at k·n/E slots a token, the head, and q·k
    (nope + rope dims) and p·v (v dims) over the causal half."""
    m = dims(cfg)
    d, H, kv, nope, rope, vd = (m[k] for k in ("d", "H", "kv", "nope",
                                               "rope", "vd"))
    L, Ld = m["L"], m["Ld"]
    mla = d * H * (nope + rope) + d * (kv + rope) + kv * H * (nope + vd) \
        + H * vd * d
    moe = d * m["E"] + 3 * d * m["ff"] * m["shared"] \
        + 3 * d * m["ff"] * m["k"] * m["n"] / m["E"]
    per_token = 2 * (L * mla + Ld * 3 * d * m["ffd"] + (L - Ld) * moe
                     + m["V"] * d)
    attn = L * tokens_per_seq ** 2 * H * (nope + rope + vd)
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
        self.scaling = float(cfg["routed_scaling_factor"])
        self.prec = prec
        self.dt = prec.dtype

    def layers(self, p: Dict):
        """Each layer's leaves by name under its block: the dense ones,
        then the MoE ones unstacked."""
        out = []
        for i in range(self.m["Ld"]):
            pre = f"lead/{i}/"
            out.append({k[len(pre):]: v for k, v in p.items()
                        if k.startswith(pre)})
        pre = "layers/0/"
        keys = [k for k in p if k.startswith(pre)]
        per = [torch.unbind(p[k]) for k in keys]
        out += [dict(zip((k[len(pre):] for k in keys), ts))
                for ts in zip(*per)]
        return out

    def attention(self, lp: Dict, z: torch.Tensor) -> torch.Tensor:
        B, S, d = z.shape
        H, kv, nope, rp, vd = (self.m[k] for k in ("H", "kv", "nope", "rope",
                                                   "vd"))
        mm = self.prec.mm
        q = mm(z, lp["mla/wq"].reshape(d, -1)).view(B, S, H, nope + rp)
        c, k_pe = mm(z, lp["mla/wkv_a"]).split([kv, rp], dim=-1)
        c = rmsnorm(c, lp["mla/kv_norm/scale"], self.eps)
        kvh = mm(c, lp["mla/wkv_b"].reshape(kv, -1)).view(B, S, H, nope + vd)
        k_nope, v = kvh.split([nope, vd], dim=-1)
        q_nope, q_pe = q.split([nope, rp], dim=-1)
        q = torch.cat([q_nope, rope(q_pe, self.theta)], dim=-1)
        k_pe = rope(k_pe[:, :, None, :], self.theta).expand(B, S, H, rp)
        k = torch.cat([k_nope, k_pe], dim=-1)
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 3, 1)
        vh = v.permute(0, 2, 1, 3)
        # 1/sqrt(nope + rope) rounded to f32, as the configuration computes
        scale = torch.tensor(1.0 / math.sqrt(nope + rp), dtype=torch.float32)
        logits = mm(qh, kh).to(torch.float32) * scale.item()
        causal = torch.ones((S, S), dtype=torch.bool,
                            device=z.device).tril()
        logits = torch.where(causal, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(self.dt)
        o = mm(probs, vh).permute(0, 2, 1, 3).reshape(B, S, H * vd)
        return mm(o, lp["mla/wo"].reshape(H * vd, d))

    def swiglu(self, z, w_in, w_gate, w_out):
        mm = self.prec.mm
        return mm(F.silu(mm(z, w_gate)) * mm(z, w_in), w_out)

    def moe(self, lp: Dict, z: torch.Tensor) -> torch.Tensor:
        B, S, d = z.shape
        zt = z.reshape(B * S, d)
        bias = lp["moe/score_bias"]
        logits = zt.to(torch.float32) @ lp["moe/router"].to(torch.float32)
        # + 0·bias: the bias takes part in the graph with a zero gradient
        scores = torch.sigmoid(logits) + 0.0 * bias
        choice = scores.detach() + bias.detach()
        top = torch.sort(choice, dim=-1, descending=True,
                         stable=True).indices[:, :self.m["k"]]
        w = torch.gather(scores, -1, top)
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20) * self.scaling
        out = torch.zeros((B * S, d), dtype=torch.float32, device=z.device)
        for j in range(self.m["n"]):
            hit = top == self.m["lo"] + j
            rows = hit.any(dim=-1)
            if not rows.any():          # no token chose it: it adds nothing
                continue
            y = self.swiglu(zt[rows], lp["moe/w_in"][j], lp["moe/w_gate"][j],
                            lp["moe/w_out"][j])
            wj = torch.sum(w * hit, dim=-1)[rows]
            out = out.index_put((rows,), y.to(torch.float32) * wj[:, None],
                                accumulate=True)
        shared = self.swiglu(z, lp["moe/shared/w_in"],
                             lp["moe/shared/w_gate"], lp["moe/shared/w_out"])
        return out.to(self.dt).view(B, S, d) + shared

    def block(self, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(lp, rmsnorm(x, lp["ln1/scale"], self.eps))
        z = rmsnorm(x, lp["ln2/scale"], self.eps)
        if "ffn/w_in" in lp:
            return x + self.swiglu(z, lp["ffn/w_in"], lp["ffn/w_gate"],
                                   lp["ffn/w_out"])
        return x + self.moe(lp, z)

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
        return h.to(torch.float32) @ p["lm_head/w"].to(torch.float32)
