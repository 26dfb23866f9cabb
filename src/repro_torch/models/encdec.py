"""Encoder-decoder transformer (seamless-m4t-medium backbone).

The JAX package's ``models/encdec.py``. The audio frontend is a stub: the
encoder takes precomputed frame embeddings (B, T_frames, d_model). The
encoder is bidirectional; each decoder layer runs causal self-attention,
cross-attention to the encoder memory (no RoPE on its K/V) and a SwiGLU
FFN, and the 256k-vocabulary head is a separate ``lm_head``. Params keep
the reference's layout (``enc_layers``/``dec_layers`` stacked on a
leading layer axis), so its ``EncDec.init`` tree loads unchanged.

Serving: ``prefill`` encodes the frames, teacher-forces the prompt
through the decoder, and caches each layer's self-attention K/V (a ring
buffer) and its *projected* memory K/V (computed once). ``decode_step``
is one decoder token; its cross-attention query takes no ``bq``, as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.threesfc import SynData, soft_xent
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import params as P_
from repro_torch.models.transformer import LOSS_CHUNK, _periods

PyTree = Any


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": layers.rmsnorm_init(d, dtype, dev),
        "attn": attn_mod.attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, cfg.qkv_bias,
                                   dtype),
        "ln2": layers.rmsnorm_init(d, dtype, dev),
        "ffn": layers.ffn_init(gen, d, cfg.d_ff, dtype),
    }


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": layers.rmsnorm_init(d, dtype, dev),
        "attn": attn_mod.attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, cfg.qkv_bias,
                                   dtype),
        "lnx": layers.rmsnorm_init(d, dtype, dev),
        "xattn": attn_mod.attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, cfg.qkv_bias,
                                    dtype),
        "ln2": layers.rmsnorm_init(d, dtype, dev),
        "ffn": layers.ffn_init(gen, d, cfg.d_ff, dtype),
    }


class EncDec:
    """Functional encoder-decoder facade bound to a ModelConfig."""

    def __init__(self, cfg: ModelConfig):
        if cfg.enc_layers <= 0:
            raise ValueError(f"{cfg.name}: EncDec needs enc_layers > 0")
        self.cfg = cfg
        self.param_dtype = P_.dtype_of(cfg.param_dtype)
        self.dtype = P_.dtype_of(cfg.dtype)

    def init(self, gen: torch.Generator) -> PyTree:
        """Fresh params drawn from ``gen``, on the generator's device."""
        cfg, dt = self.cfg, self.param_dtype
        return {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "enc_layers": P_.stack_init(
                lambda g: _enc_block_init(g, cfg, dt), gen, cfg.enc_layers),
            "enc_norm": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
            "dec_layers": P_.stack_init(
                lambda g: _dec_block_init(g, cfg, dt), gen, cfg.num_layers),
            "final_norm": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
            "lm_head": layers.lm_head_init(gen, cfg.d_model, cfg.vocab_size,
                                           dt),
        }

    def _stack(self, block, x, stacked, n, *extra):
        """``x`` through ``n`` stacked layers, each under a checkpoint when
        ``cfg.remat`` and autograd records (the reference's remat'd
        scan)."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for p in _periods(stacked, n):
            x = (checkpoint(block, p, x, *extra, use_reentrant=False)
                 if remat else block(p, x, *extra))
        return x

    # ---- encoder ----------------------------------------------------------

    def encode(self, params: PyTree, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, d) stub embeddings -> encoder memory (B, T, d)."""
        cfg = self.cfg
        eps = cfg.norm_eps

        def block(p, x):
            x = x + attn_mod.attention(
                p["attn"], layers.rmsnorm(p["ln1"], x, eps),
                theta=cfg.rope_theta, causal=False)
            return x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x, eps))

        x = self._stack(block, frames.to(self.dtype), params["enc_layers"],
                        cfg.enc_layers)
        return layers.rmsnorm(params["enc_norm"], x, eps)

    # ---- decoder (teacher-forced) ------------------------------------------

    def _decoder_hidden(self, params: PyTree, x: torch.Tensor,
                        memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        eps = cfg.norm_eps

        def block(p, x, memory):
            x = x + attn_mod.attention(
                p["attn"], layers.rmsnorm(p["ln1"], x, eps),
                theta=cfg.rope_theta, window=cfg.attn_window)
            x = x + attn_mod.attention(
                p["xattn"], layers.rmsnorm(p["lnx"], x, eps),
                theta=cfg.rope_theta, xkv=memory, causal=False)
            return x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x, eps))

        x = self._stack(block, x, params["dec_layers"], cfg.num_layers,
                        memory)
        return layers.rmsnorm(params["final_norm"], x, eps)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """batch: frames (B, T, d), tokens (B, S). Next-token CE in chunks
        of LOSS_CHUNK positions (the 256k vocabulary), summed over every
        position and divided by B·(S−1): no mask."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = layers.embed(params["embed"], tokens, self.dtype)
        h = self._decoder_hidden(params, x, memory)
        hs, targets = h[:, :-1, :], tokens[:, 1:].long()
        chunk = min(LOSS_CHUNK, S - 1)

        def ce(hc, tc):
            logp = torch.log_softmax(layers.lm_head(params["lm_head"], hc),
                                     dim=-1)
            return torch.sum(-torch.gather(logp, -1, tc[..., None])[..., 0])

        def ce_remat(hc, tc):
            if torch.is_grad_enabled():
                return checkpoint(ce, hc, tc, use_reentrant=False)
            return ce(hc, tc)

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        # whole chunks in order, then the remainder, as the reference sums
        for start in range(0, S - 1, chunk):
            sl = slice(start, start + chunk)
            tot = tot + ce_remat(hs[:, sl], targets[:, sl])
        return tot / float(B * (S - 1))

    # ---- synthetic features -------------------------------------------------

    def syn_loss(self, params: PyTree, syn: SynData, enc_len: int
                 ) -> torch.Tensor:
        """syn.x = (n, Le + Ld, d): the first ``enc_len`` positions are
        encoder frames, the rest decoder soft embeddings; the labels cover
        the Ld positions."""
        memory = self.encode(params, syn.x[:, :enc_len, :])
        h = self._decoder_hidden(params, syn.x[:, enc_len:, :].to(self.dtype),
                                 memory)
        return soft_xent(layers.lm_head(params["lm_head"], h), syn.labels())

    # ---- serving ------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, enc_len: int,
                   dtype=torch.bfloat16, device=None) -> PyTree:
        cfg = self.cfg
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        one = attn_mod.init_cache(batch, cache_len, kv, hd, dtype, device)
        self_kv = tree_map(lambda x: x.expand(L, *x.shape).clone(), one)
        mem_kv = {k: torch.zeros((L, batch, enc_len, kv, hd), dtype=dtype,
                                 device=device) for k in ("k", "v")}
        return {"self": self_kv, "mem": mem_kv}

    def prefill(self, params: PyTree, frames: torch.Tensor,
                tokens: torch.Tensor, cache_len: int):
        """Encode the frames, teacher-force the tokens, build the decode
        caches. Returns (last-token logits (B, V), cache, t0)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        memory = self.encode(params, frames)
        x = layers.embed(params["embed"], tokens, self.dtype)
        selfs, mems = [], []
        for p in _periods(params["dec_layers"], cfg.num_layers):
            h, kv = attn_mod.prefill_cache(
                p["attn"], layers.rmsnorm(p["ln1"], x, eps), cache_len,
                theta=cfg.rope_theta, window=cfg.attn_window)
            x = x + h
            # project this layer's encoder memory K/V once
            _, mk, mv = attn_mod._project_qkv(p["xattn"], memory[:, :1, :],
                                              memory)
            x = x + attn_mod.attention(
                p["xattn"], layers.rmsnorm(p["lnx"], x, eps),
                theta=cfg.rope_theta, xkv=memory, causal=False)
            x = x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x, eps))
            selfs.append(kv)
            mems.append({"k": mk, "v": mv})
        x = layers.rmsnorm(params["final_norm"], x, eps)
        logits = layers.lm_head(params["lm_head"], x[:, -1, :])
        return (logits, {"self": P_.stack_trees(selfs),
                         "mem": P_.stack_trees(mems)}, tokens.shape[1])

    def decode_step(self, params: PyTree, cache: PyTree,
                    token: torch.Tensor, t):
        """token (B,) int, t position. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        L = cfg.num_layers
        x_t = layers.embed(params["embed"], token, self.dtype)
        new_self = []
        for p, sc, mk, mv in zip(_periods(params["dec_layers"], L),
                                 _periods(cache["self"], L),
                                 torch.unbind(cache["mem"]["k"]),
                                 torch.unbind(cache["mem"]["v"])):
            h, sc = attn_mod.decode_attention(
                p["attn"], layers.rmsnorm(p["ln1"], x_t, eps), sc, t,
                theta=cfg.rope_theta, window=cfg.attn_window)
            x_t = x_t + h
            # cross-attention against the cached projected memory; the
            # query takes no bq, as the reference's
            z = layers.rmsnorm(p["lnx"], x_t, eps)
            q = attn_mod._proj(z[:, None, :], p["xattn"]["wq"])
            out = attn_mod._sdpa(q, mk, mv, None)[:, 0]
            x_t = x_t + attn_mod._out(out, p["xattn"]["wo"], z.dtype)
            x_t = x_t + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x_t,
                                                           eps))
            new_self.append(sc)
        x_t = layers.rmsnorm(params["final_norm"], x_t, eps)
        return (layers.lm_head(params["lm_head"], x_t),
                {"self": P_.stack_trees(new_self), "mem": cache["mem"]})
