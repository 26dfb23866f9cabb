"""Decoder-only LM covering the dense, MoE, SSM and hybrid families.

Layers are grouped into *periods* = one repetition of ``cfg.block_pattern``
(uniform archs: pattern ("attn",) -> period == layer). Period params carry a
leading ``n_periods`` axis, in the JAX package's layout (``"layers"``, keyed
``"0"``…), so its ``LM.init`` tree loads unchanged; here the periods run as
a Python loop over that axis. A non-divisible remainder becomes ``tail``
blocks (recurrentgemma: 26 = 3·8 + 2). ``cfg.first_dense_layers`` blocks
of the pattern's first type run ahead of the periods as ``lead`` blocks
with a dense FFN of width ``cfg.dense_d_ff`` (moonlight: 1 dense, then 26
MoE periods).

Big-vocab discipline: the (B, S, V) logits never materialize. Training CE
walks the sequence in chunks of ``LOSS_CHUNK`` positions (each recomputed
in the backward, as the reference remats it); prefill projects only the
last position and decode a single token.

With ``cfg.remat`` and autograd recording, each period runs under
``torch.utils.checkpoint`` (non-reentrant, so grad-of-grad works), the
counterpart of the reference's ``jax.checkpoint(period_fn)``: the backward
recomputes a period's forward instead of keeping its activations; so does
each lead block.

Synthetic features (3SFC): ``syn_loss`` takes soft input embeddings
(n, L, d) and soft labels (dense or low-rank over the vocab).

The blocks: ``"attn"`` (attention + SwiGLU FFN, or + MoE when
``cfg.num_experts``), ``"mla"`` (latent attention, ``models/mla.py``, +
the same FFN or MoE; training only, no cache), ``"ssm"`` (the mamba2
mixer) and ``"rec"`` (RG-LRU + FFN). The MoE is the capacity route, or
with ``cfg.router == "sigmoid"`` the dropless route over the held
experts (``models/moe.py``; no auxiliary loss). Multimodal prefixes
(``prefix_embeds`` (B, T_mm, d)) are concatenated in front of the token
embeddings; the loss masks them out.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.threesfc import SynData, soft_xent
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as P_
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod

PyTree = Any
LOSS_CHUNK = 512          # sequence-chunked CE block size


# ---------------------------------------------------------------------------
# pattern helpers
# ---------------------------------------------------------------------------


def pattern_layout(cfg: ModelConfig
                   ) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, n_periods, tail_pattern) of the layers after the lead."""
    pat = tuple(cfg.block_pattern)
    rest = cfg.num_layers - cfg.first_dense_layers
    n_periods = rest // len(pat)
    tail = pat[: rest % len(pat)]
    return pat, n_periods, tail


def _block_error(btype: str) -> Exception:
    return ValueError(f"unknown block type {btype!r}")


def _rnn_width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def _cache_len(cfg: ModelConfig, cache_len: int) -> int:
    """An attention block's ring: at most the window."""
    return min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len


# ---------------------------------------------------------------------------
# block init / forward / cache / prefill / decode
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ModelConfig, btype: str,
                dtype, dense: bool = False) -> Dict:
    """``dense``: a lead block, its FFN ``cfg.dense_d_ff`` wide."""
    d, dev = cfg.d_model, gen.device
    if btype in ("attn", "mla"):
        p = {"ln1": layers.rmsnorm_init(d, dtype, dev)}
        if btype == "attn":
            p["attn"] = attn_mod.attn_init(gen, d, cfg.num_heads,
                                           cfg.num_kv_heads,
                                           cfg.resolved_head_dim,
                                           cfg.qkv_bias, dtype)
        else:
            p["mla"] = mla_mod.mla_init(gen, d, cfg.num_heads,
                                        cfg.kv_lora_rank,
                                        cfg.qk_nope_head_dim,
                                        cfg.qk_rope_head_dim,
                                        cfg.v_head_dim, dtype)
        p["ln2"] = layers.rmsnorm_init(d, dtype, dev)
        if cfg.num_experts and not dense:
            p["moe"] = moe_mod.moe_init(
                gen, d, cfg.d_ff, cfg.num_experts, cfg.shared_experts, dtype,
                held=cfg.held_experts, score_bias=cfg.router == "sigmoid")
        else:
            p["ffn"] = layers.ffn_init(
                gen, d, (cfg.dense_d_ff or cfg.d_ff) if dense else cfg.d_ff,
                dtype)
        return p
    if btype == "ssm":
        dims = ssm_mod.SSMDims.from_cfg(cfg)
        return {"ln1": layers.rmsnorm_init(d, dtype, dev),
                "ssm": ssm_mod.ssm_init(gen, dims, dtype)}
    if btype == "rec":
        return {
            "ln1": layers.rmsnorm_init(d, dtype, dev),
            "rglru": rglru_mod.rglru_init(gen, d, _rnn_width(cfg),
                                          cfg.conv_width, dtype),
            "ln2": layers.rmsnorm_init(d, dtype, dev),
            "ffn": layers.ffn_init(gen, d, cfg.d_ff, dtype),
        }
    raise _block_error(btype)


def _ffn_or_moe(cfg: ModelConfig, p: Dict, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An attention block's second half on its normed input: (y, aux),
    aux None where the block adds none (a dense FFN, the dropless
    route)."""
    if "moe" in p and cfg.router == "sigmoid":
        return moe_mod.moe_dropless(
            p["moe"], z, experts_per_token=cfg.experts_per_token,
            scaling=cfg.routed_scaling_factor,
            held_start=cfg.held_expert_start), None
    if "moe" in p:
        out = moe_mod.moe_ffn(p["moe"], z,
                              experts_per_token=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor,
                              aux_coef=cfg.moe_aux_coef)
        return out.y, out.aux_loss
    return layers.ffn(p["ffn"], z), None


def _block_forward(cfg: ModelConfig, btype: str, p: Dict, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    eps = cfg.norm_eps
    if btype in ("attn", "mla"):
        z = layers.rmsnorm(p["ln1"], x, eps)
        if btype == "attn":
            x = x + attn_mod.attention(p["attn"], z, theta=cfg.rope_theta,
                                       window=cfg.attn_window)
        else:
            x = x + mla_mod.mla(p["mla"], z, theta=cfg.rope_theta,
                                rope_dim=cfg.qk_rope_head_dim, eps=eps)
        y, a = _ffn_or_moe(cfg, p, layers.rmsnorm(p["ln2"], x, eps))
        return x + y, aux if a is None else aux + a
    if btype == "ssm":
        dims = ssm_mod.SSMDims.from_cfg(cfg)
        y, _ = ssm_mod.ssm_forward(
            p["ssm"], layers.rmsnorm(p["ln1"], x, eps), dims)
        return x + y, aux
    if btype == "rec":
        y, _ = rglru_mod.rglru_forward(p["rglru"],
                                       layers.rmsnorm(p["ln1"], x, eps))
        x = x + y
        return x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x, eps)), aux
    raise _block_error(btype)


def _no_serving(btype: str) -> Exception:
    return NotImplementedError(f"block type {btype!r} has no decode cache "
                               f"(training only)")


def _block_cache(cfg: ModelConfig, btype: str, batch: int, cache_len: int,
                 dtype, device):
    if btype == "mla":
        raise _no_serving(btype)
    if btype == "attn":
        return attn_mod.init_cache(batch, _cache_len(cfg, cache_len),
                                   cfg.num_kv_heads, cfg.resolved_head_dim,
                                   dtype, device)
    if btype == "ssm":
        return ssm_mod.init_ssm_cache(batch, ssm_mod.SSMDims.from_cfg(cfg),
                                      dtype, device)
    if btype == "rec":
        return rglru_mod.init_rglru_cache(batch, _rnn_width(cfg),
                                          cfg.conv_width, dtype, device)
    raise _block_error(btype)


def _block_prefill(cfg: ModelConfig, btype: str, p: Dict, x: torch.Tensor,
                   cache_len: int):
    """Full forward + populated cache for this block."""
    eps = cfg.norm_eps
    if btype == "mla":
        raise _no_serving(btype)
    if btype == "attn":
        h, kv = attn_mod.prefill_cache(
            p["attn"], layers.rmsnorm(p["ln1"], x, eps),
            _cache_len(cfg, cache_len), theta=cfg.rope_theta,
            window=cfg.attn_window)
        x = x + h
        y, _ = _ffn_or_moe(cfg, p, layers.rmsnorm(p["ln2"], x, eps))
        return x + y, kv
    if btype == "ssm":
        dims = ssm_mod.SSMDims.from_cfg(cfg)
        xin = layers.rmsnorm(p["ln1"], x, eps)
        y, final = ssm_mod.ssm_forward(p["ssm"], xin, dims)
        # conv buffer = the last (width-1) conv inputs, before the conv
        _, xc, Bc, Cc, _ = ssm_mod._split_proj(
            p["ssm"], xin[:, -(dims.conv_width - 1):, :], dims)
        buf = torch.cat([xc, Bc, Cc], dim=-1).to(final.dtype)
        return x + y, ssm_mod.SSMCache(buf, final)
    if btype == "rec":
        xin = layers.rmsnorm(p["ln1"], x, eps)
        y, hfin = rglru_mod.rglru_forward(p["rglru"], xin)
        # conv buffer = the last (width-1) conv inputs, before the conv
        xconv = xin[:, -(cfg.conv_width - 1):, :] @ p["rglru"]["w_in"].to(
            x.dtype)
        x = x + y
        x = x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x, eps))
        return x, rglru_mod.RGLRUCache(xconv, hfin)
    raise _block_error(btype)


def _block_decode(cfg: ModelConfig, btype: str, p: Dict, x_t: torch.Tensor,
                  cache, t):
    eps = cfg.norm_eps
    if btype == "mla":
        raise _no_serving(btype)
    if btype == "attn":
        h, cache = attn_mod.decode_attention(
            p["attn"], layers.rmsnorm(p["ln1"], x_t, eps), cache, t,
            theta=cfg.rope_theta, window=cfg.attn_window)
        x_t = x_t + h
        y, _ = _ffn_or_moe(cfg, p,
                           layers.rmsnorm(p["ln2"], x_t, eps)[:, None, :])
        return x_t + y[:, 0, :], cache
    if btype == "ssm":
        dims = ssm_mod.SSMDims.from_cfg(cfg)
        y, cache = ssm_mod.ssm_decode_step(
            p["ssm"], layers.rmsnorm(p["ln1"], x_t, eps), cache, dims)
        return x_t + y, cache
    if btype == "rec":
        y, cache = rglru_mod.rglru_decode_step(
            p["rglru"], layers.rmsnorm(p["ln1"], x_t, eps), cache)
        x_t = x_t + y
        x_t = x_t + layers.ffn(p["ffn"], layers.rmsnorm(p["ln2"], x_t, eps))
        return x_t, cache
    raise _block_error(btype)


def _periods(tree: PyTree, n: int) -> list:
    """The ``n`` periods of a tree stacked on a leading axis, as views from
    one ``torch.unbind`` per leaf: its backward is one ``stack`` per leaf,
    where indexing each period would write a zero tensor of the whole
    stacked leaf per period."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(treedef, [ts[i] for ts in per_leaf])
            for i in range(n)]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class LM:
    """Functional decoder-only LM facade bound to a ModelConfig."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pattern, self.n_periods, self.tail = pattern_layout(cfg)
        self.lead = self.pattern[:1] * cfg.first_dense_layers
        self.param_dtype = P_.dtype_of(cfg.param_dtype)
        self.dtype = P_.dtype_of(cfg.dtype)

    # ---- init -------------------------------------------------------------

    def init(self, gen: torch.Generator) -> PyTree:
        """Fresh params drawn from ``gen``, on the generator's device."""
        cfg = self.cfg

        def period_init(g):
            return {str(i): _block_init(g, cfg, bt, self.param_dtype)
                    for i, bt in enumerate(self.pattern)}

        params = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       self.param_dtype),
            "layers": P_.stack_init(period_init, gen, self.n_periods),
            "final_norm": layers.rmsnorm_init(cfg.d_model, self.param_dtype,
                                              gen.device),
        }
        if self.tail:
            params["tail"] = {str(i): _block_init(gen, cfg, bt,
                                                  self.param_dtype)
                              for i, bt in enumerate(self.tail)}
        if self.lead:
            params["lead"] = {str(i): _block_init(gen, cfg, bt,
                                                  self.param_dtype,
                                                  dense=True)
                              for i, bt in enumerate(self.lead)}
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.lm_head_init(
                gen, cfg.d_model, cfg.vocab_size, self.param_dtype)
        return params

    # ---- shared trunk -----------------------------------------------------

    def _trunk(self, params: PyTree, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, d) -> (hidden (B, S, d), aux). One loop over periods."""
        cfg = self.cfg

        def period_fn(pp, x):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, bt in enumerate(self.pattern):
                x, a = _block_forward(cfg, bt, pp[str(i)], x)
                aux = aux + a
            return x, aux

        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, bt in enumerate(self.lead):
            fn = functools.partial(_block_forward, cfg, bt)
            p = params["lead"][str(i)]
            x, a = (checkpoint(fn, p, x, use_reentrant=False,
                               preserve_rng_state=False)
                    if remat else fn(p, x))
            aux = aux + a
        for pp in _periods(params["layers"], self.n_periods):
            if remat:
                # no RNG state stashed: the periods draw no random numbers,
                # and the stash (a read of the CUDA generator's offset)
                # cannot be captured into the encode's CUDA graph
                x, a = checkpoint(period_fn, pp, x, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = period_fn(pp, x)
            aux = aux + a
        for i, bt in enumerate(self.tail):
            x, a = _block_forward(cfg, bt, params["tail"][str(i)], x)
            aux = aux + a
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux

    def _logits(self, params: PyTree, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return layers.unembed(params["embed"], h)
        return layers.lm_head(params["lm_head"], h)

    def embed_tokens(self, params: PyTree, tokens: torch.Tensor
                     ) -> torch.Tensor:
        return layers.embed(params["embed"], tokens, self.dtype)

    def forward_hidden(self, params: PyTree, tokens: torch.Tensor,
                       prefix_embeds: Optional[torch.Tensor] = None):
        x = self.embed_tokens(params, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        return self._trunk(params, x)

    # ---- training ---------------------------------------------------------

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Next-token CE, sequence-chunked so (B, S, V) never materializes.

        batch: tokens (B, S) int, optional prefix_embeds (B, T, d) (masked
        out of the loss), optional mask (B, S) f32. Returns
        ``tot / max(cnt, 1) + aux``.
        """
        tokens = batch["tokens"]
        B, S = tokens.shape
        h, aux = self.forward_hidden(params, tokens,
                                     batch.get("prefix_embeds"))
        T = h.shape[1] - S
        h = h[:, T:, :]                                # token positions only
        targets = tokens[:, 1:].long()
        mask = batch.get("mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=h.device)
                if mask is None else mask[:, 1:].to(torch.float32))
        hs = h[:, :-1, :]
        chunk = min(LOSS_CHUNK, S - 1)

        def ce(hc, tc, mc):
            logp = torch.log_softmax(self._logits(params, hc), dim=-1)
            nll = -torch.gather(logp, -1, tc[..., None])[..., 0]
            return torch.sum(nll * mc), torch.sum(mc)

        def ce_remat(hc, tc, mc):
            if torch.is_grad_enabled():
                return checkpoint(ce, hc, tc, mc, use_reentrant=False)
            return ce(hc, tc, mc)

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        # whole chunks in order, then the remainder, as the reference sums
        for start in range(0, S - 1, chunk):
            sl = slice(start, start + chunk)
            s_, c_ = ce_remat(hs[:, sl], targets[:, sl], mask[:, sl])
            tot, cnt = tot + s_, cnt + c_
        return tot / torch.clamp(cnt, min=1.0) + aux

    # ---- synthetic features (3SFC payload) ---------------------------------

    def syn_loss(self, params: PyTree, syn: SynData) -> torch.Tensor:
        """Soft-embedding inputs -> soft-label CE (the compressor's F)."""
        h, aux = self._trunk(params, syn.x.to(self.dtype))
        return soft_xent(self._logits(params, h), syn.labels()) + aux

    # ---- serving ----------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None) -> PyTree:
        cfg = self.cfg
        period = {str(i): _block_cache(cfg, bt, batch, cache_len, dtype,
                                       device)
                  for i, bt in enumerate(self.pattern)}
        cache = {"layers": tree_map(
            lambda x: x.expand(self.n_periods, *x.shape).clone(), period)}
        if self.tail:
            cache["tail"] = {str(i): _block_cache(cfg, bt, batch, cache_len,
                                                  dtype, device)
                             for i, bt in enumerate(self.tail)}
        return cache

    def prefill(self, params: PyTree, tokens: torch.Tensor, cache_len: int,
                prefix_embeds: Optional[torch.Tensor] = None):
        """Returns (last-token logits (B, V), cache, t0)."""
        cfg = self.cfg
        x = self.embed_tokens(params, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        per_period = []
        for pp in _periods(params["layers"], self.n_periods):
            caches = {}
            for i, bt in enumerate(self.pattern):
                x, caches[str(i)] = _block_prefill(cfg, bt, pp[str(i)], x,
                                                   cache_len)
            per_period.append(caches)
        cache = {"layers": P_.stack_trees(per_period)}
        if self.tail:
            cache["tail"] = {}
            for i, bt in enumerate(self.tail):
                x, cache["tail"][str(i)] = _block_prefill(
                    cfg, bt, params["tail"][str(i)], x, cache_len)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x[:, -1, :])
        return logits, cache, x.shape[1]

    def decode_step(self, params: PyTree, cache: PyTree,
                    token: torch.Tensor, t):
        """token (B,) int, t position. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        x_t = layers.embed(params["embed"], token, self.dtype)
        per_period = []
        for pp, pc in zip(_periods(params["layers"], self.n_periods),
                          _periods(cache["layers"], self.n_periods)):
            new_c = {}
            for i, bt in enumerate(self.pattern):
                x_t, new_c[str(i)] = _block_decode(cfg, bt, pp[str(i)], x_t,
                                                   pc[str(i)], t)
            per_period.append(new_c)
        new_cache = {"layers": P_.stack_trees(per_period)}
        if self.tail:
            new_cache["tail"] = {}
            for i, bt in enumerate(self.tail):
                x_t, new_cache["tail"][str(i)] = _block_decode(
                    cfg, bt, params["tail"][str(i)], x_t,
                    cache["tail"][str(i)], t)
        x_t = layers.rmsnorm(params["final_norm"], x_t, cfg.norm_eps)
        return self._logits(params, x_t), new_cache
