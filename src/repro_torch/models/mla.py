"""Multi-head latent attention (DeepSeek-V2/V3's MLA), in the un-absorbed
training form, with no q compression.

Weights (x of width d, H heads):
  wq (d, H, nope + rope)        q per head: a position-free part and a
                                rotary part
  wkv_a (d, kv_lora + rope)     the kv latent and one rotary key that all
                                heads share
  kv_norm {"scale": (kv_lora,)} RMSNorm of the latent
  wkv_b (kv_lora, H, nope + v)  the normed latent to each head's
                                position-free key and its value
  wo (H, v, d)

q·k runs over ``nope + rope`` dims (scale 1/sqrt(nope + rope)) and the
values have ``v`` dims; the attention itself is
``attention.causal_self_attention`` (f32 logits and softmax: kernel B7 on
the card in bf16, else ``_sdpa`` with ``causal_mask``) and the rotation
``rope.apply_rope``, which turns the two halves of the rope dims against
each other. Published checkpoints store those dims as interleaved pairs
(their loaders permute them before rotating halves); with weights drawn
from a seed the two forms are one model up to a fixed permutation of the
rope columns of ``wq`` and ``wkv_a``.

Each call is one ``mla.attention`` span (``obs.layer_span``), the remat's
recompute included; the backward is not in it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import params as P_
from repro_torch.models.rope import apply_rope
from repro_torch.obs import layer_span


def mla_init(gen: torch.Generator, d: int, num_heads: int, kv_lora: int,
             nope: int, rope: int, v: int, dtype=torch.float32) -> Dict:
    return {
        "wq": P_.dense_init(gen, d, (d, num_heads, nope + rope), dtype),
        "wkv_a": P_.dense_init(gen, d, (d, kv_lora + rope), dtype),
        "kv_norm": layers.rmsnorm_init(kv_lora, dtype, gen.device),
        "wkv_b": P_.dense_init(gen, kv_lora, (kv_lora, num_heads, nope + v),
                               dtype),
        "wo": P_.dense_init(gen, num_heads * v, (num_heads, v, d), dtype),
    }


def mla(p: Dict, x: torch.Tensor, *, theta: float, rope_dim: int,
        eps: float, positions: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """Causal self-attention over x (B, S, d) -> (B, S, d), in x's dtype
    with the latent's norm, the rotation, logits and softmax in f32."""
    with layer_span("mla.attention", x):
        S = x.shape[-2]
        kv_lora = p["kv_norm"]["scale"].shape[0]
        nope = p["wq"].shape[-1] - rope_dim
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q_nope, q_pe = attn_mod._proj(x, p["wq"]).split([nope, rope_dim], -1)
        c, k_pe = (x @ p["wkv_a"].to(x.dtype)).split([kv_lora, rope_dim], -1)
        kv = attn_mod._proj(layers.rmsnorm(p["kv_norm"], c, eps), p["wkv_b"])
        k_nope, v = kv.split([nope, kv.shape[-1] - nope], -1)
        q = torch.cat([q_nope, apply_rope(q_pe, positions, theta)], -1)
        k_pe = apply_rope(k_pe[..., None, :], positions, theta)
        k = torch.cat([k_nope, k_pe.expand_as(q_pe)], -1)
        out = attn_mod.causal_self_attention(q, k, v)
        return attn_mod._out(out, p["wo"])
