"""CompressionStrategy: one protocol object per compression method.

The port of the JAX package's ``core/strategy.py``: the methods with a wire
format — ``identity`` (FedAvg), ``topk`` (DGC), ``signsgd``, ``stc`` and
``threesfc`` — and the accounted-only ``randk`` and ``fedsynth``. A
strategy carries:

* ``client_encode(key, u, params) -> TreeCompressed`` — the per-client
  encoder. ``key`` is a ``torch.Generator`` the encoder draws from (3SFC's
  initial ``D_syn``); a ready ``SynData`` in its place is used as the
  initial ``D_syn`` directly (the seam that lets tests start from the
  reference's draws); for ``randk`` a tuple of per-leaf index tensors in
  its place is used as the draws.
* ``server_decode(payload, params)`` — one client's reconstruction from
  its canonical wire payload.
* ``server_aggregate(params, payloads)`` (when
  ``supports_fused_aggregate``) — the aggregate straight from the batched
  payloads.
* ``wire_codec(params, policy=...)`` — the method's byte codec
  (``repro_torch.comm.codec``).
* ``payload_floats(params)`` and ``init_ef_state(params)``.

The base class provides the derived steps the FL round consumes —
``step`` (float mode), ``payload_step`` (fused mode) and ``wire_step``
(codec mode) — sharing one copy of the Eq. 6 EF algebra; when an encoder
factors ``recon = scale · direction``, the EF residual is one pass of
kernel B2 (``ops.tree_ef_update``).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, NamedTuple, Optional, Type

import torch

from repro_torch.configs.base import CompressorConfig
from repro_torch.core import baselines, flat
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels import ops
from repro_torch.models import shard

PyTree = Any


class CompressMetrics(NamedTuple):
    cosine: torch.Tensor             # compression efficiency (Fig. 7)
    payload_floats: torch.Tensor     # accounted wire size this round
    aux: torch.Tensor                # method-specific (3SFC: objective; else 0)


class TreeCompressed(NamedTuple):
    """What a strategy's ``client_encode`` hands back to the shared steps.

    ``cosine`` (when not None) is the already-computed cos(recon, u);
    ``direction``/``scale`` (when not None) factor ``recon = scale ·
    direction`` so the EF update runs as one fused ``e' = u − s·direction``
    stream; ``wire`` is the method's wire payload.
    """

    recon: Any
    floats: torch.Tensor
    aux: torch.Tensor
    cosine: Optional[torch.Tensor] = None
    direction: Any = None
    scale: Optional[torch.Tensor] = None
    wire: Any = None


def leaf_k(n: int, ratio: float) -> int:
    """Kept entries for a size-n leaf at ``keep_ratio`` — the one source of
    per-leaf budgets (the wire codecs derive their layouts from it)."""
    return max(1, int(round(ratio * n)))


_DEPRECATION_SEEN: set = set()


def warn_deprecated_once(name: str, replacement: str) -> None:
    """One DeprecationWarning per process per shim name."""
    if name in _DEPRECATION_SEEN:
        return
    _DEPRECATION_SEEN.add(name)
    warnings.warn(f"{name} is deprecated; use {replacement}",
                  DeprecationWarning, stacklevel=3)


def _device_of(tree: PyTree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _scalar(v: float, like: PyTree) -> torch.Tensor:
    # a fill on the device: no host-to-device copy, so no sync on the card
    return torch.full((), v, dtype=torch.float32, device=_device_of(like))


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


class CompressionStrategy:
    """Base class for registered compression methods (see module docstring)."""

    kind: str = ""
    supports_fused_aggregate: bool = False

    def __init__(self, cfg: CompressorConfig, *, loss_fn=None, syn_spec=None,
                 local_lr: float = 0.01):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.syn_spec = syn_spec
        self.local_lr = local_lr

    # -- protocol ----------------------------------------------------------
    def init_ef_state(self, params: PyTree) -> PyTree:
        """EF residual tree (zeros, f32) mirroring params (and placed as
        they are)."""
        return flat.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def payload_floats(self, params: PyTree) -> float:
        """Accounted per-round uplink size in floats (paper Eq. 1)."""
        raise NotImplementedError

    def client_encode(self, key, u: PyTree, params: PyTree) -> TreeCompressed:
        """Compress one client's accumulated update ``u`` at ``params``."""
        raise NotImplementedError

    def server_decode(self, payload, params: PyTree) -> PyTree:
        raise NotImplementedError(
            f"strategy {self.kind!r} has no payload decode")

    def server_aggregate(self, params: PyTree, payloads) -> PyTree:
        """Batched (leading client axis) payloads -> aggregated update, with
        the mean semantics of ``fl.server.aggregate``."""
        raise NotImplementedError(
            f"strategy {self.kind!r} does not support fused aggregation")

    def mask_payloads(self, payloads, w: torch.Tensor):
        """Weight the batched payloads by the (N,) mask ``w``."""
        raise NotImplementedError(
            f"strategy {self.kind!r} does not support masked fused "
            f"aggregation (mask_payloads)")

    def wire_codec(self, params: PyTree, *, policy: Optional[str] = None):
        """Build this method's registered byte codec over a params template.

        Raises ``KeyError`` for kinds without a wire format.
        """
        from repro_torch.comm.codec import CODECS  # lazy: comm imports core
        if self.cfg.kind not in CODECS:
            raise KeyError(
                f"no wire codec registered for compressor kind "
                f"{self.cfg.kind!r} (have: {sorted(CODECS)})")
        policy = policy or getattr(self.cfg, "wire_dtype", "fp32")
        return CODECS[self.cfg.kind](self.cfg, params, policy, strategy=self)

    # -- shared EF algebra (Eq. 6) -----------------------------------------
    def _accumulate(self, g_tree: PyTree, e_tree: PyTree) -> PyTree:
        return flat.tree_add(g_tree, e_tree) if self.cfg.error_feedback \
            else g_tree

    def _ef_update(self, u, e_tree, recon, direction, scale, *,
                   out=None) -> PyTree:
        if not self.cfg.error_feedback:
            return e_tree
        if direction is not None:
            return ops.tree_ef_update(u, direction, scale, out=out)
        if out is not None:
            return flat.tree_map(lambda o, a, b: torch.sub(a, b, out=o),
                                 out, u, recon)
        return flat.tree_sub(u, recon)

    @staticmethod
    def _efficiency_cosine(out: TreeCompressed, recon, u) -> torch.Tensor:
        """cos(recon, u) unless the method already computed it fused."""
        return out.cosine if out.cosine is not None \
            else flat.tree_cosine(recon, u)

    # -- derived steps (what fl.round calls) ---------------------------------
    def step(self, key, g_tree, e_tree, params):
        """Float mode: (recon_tree, new_e_tree, CompressMetrics)."""
        return self.encode_update(key, self._accumulate(g_tree, e_tree),
                                  e_tree, params)

    def payload_step(self, key, g_tree, e_tree, params):
        """Fused mode: (wire payload, new_e_tree, CompressMetrics)."""
        return self.encode_update(key, self._accumulate(g_tree, e_tree),
                                  e_tree, params, wire=True)

    def encode_update(self, key, u, e_tree, params, *, wire: bool = False,
                      ef_out=None):
        """``step`` (float mode) or, with ``wire``, ``payload_step`` from
        the accumulated update ``u`` = g + e: (message, new_e_tree,
        CompressMetrics). ``ef_out``, a tree shaped as the residual (``u``
        itself may be it), takes the new residual in place; the values are
        the same. The round's CUDA graph of the encode
        (``repro_torch.fl.encode_graph``) captures this function."""
        out = self.client_encode(key, u, params)
        if wire and out.wire is None:
            raise ValueError(
                f"compressor kind {self.cfg.kind!r} emits no wire payload")
        ef_args = (u, e_tree, out.recon, out.direction, out.scale)
        e_new = (self._ef_update(*ef_args) if ef_out is None
                 else self._ef_update(*ef_args, out=ef_out))
        cos = self._efficiency_cosine(out, out.recon, u)
        return (out.wire if wire else out.recon), e_new, \
            CompressMetrics(cos, out.floats, out.aux)

    def wire_step(self, key, g_tree, e_tree, params, *, codec,
                  round_idx=0, client_idx=0):
        """Codec mode: (framed uint8 buffer, new_e_tree, CompressMetrics).

        Same EF algebra as ``step``, but the reconstruction used for EF and
        the cosine is the codec's dequantized view (``Codec.client_view``),
        so the client stays consistent with what the server decodes.
        """
        u = self._accumulate(g_tree, e_tree)
        out = self.client_encode(key, u, params)
        if out.wire is None:
            raise ValueError(
                f"compressor kind {self.cfg.kind!r} emits no wire payload")
        buf = codec.encode(out.wire, round_idx=round_idx,
                           client_idx=client_idx)
        recon, direction, scale = codec.client_view(out)
        e_new = self._ef_update(u, e_tree, recon, direction, scale)
        cos = self._efficiency_cosine(out, recon, u)
        return buf, e_new, CompressMetrics(cos, out.floats, out.aux)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

STRATEGIES: Dict[str, Type[CompressionStrategy]] = {}


def register_strategy(kind: str):
    """Class decorator registering a ``CompressionStrategy`` under ``kind``;
    duplicate kinds are rejected."""

    def deco(cls: Type[CompressionStrategy]) -> Type[CompressionStrategy]:
        if kind in STRATEGIES:
            raise ValueError(
                f"strategy kind {kind!r} already registered "
                f"(by {STRATEGIES[kind].__name__})")
        cls.kind = kind
        STRATEGIES[kind] = cls
        return cls

    return deco


def strategy_kinds():
    """Sorted registered kinds."""
    return sorted(STRATEGIES)


def make_strategy(cfg: CompressorConfig, *, loss_fn=None, syn_spec=None,
                  local_lr: float = 0.01) -> CompressionStrategy:
    """Instantiate the registered strategy for ``cfg.kind``."""
    if cfg.kind not in STRATEGIES:
        raise ValueError(
            f"unknown compressor kind {cfg.kind!r} "
            f"(registered: {strategy_kinds()})")
    return STRATEGIES[cfg.kind](cfg, loss_fn=loss_fn, syn_spec=syn_spec,
                                local_lr=local_lr)


# ---------------------------------------------------------------------------
# the methods
# ---------------------------------------------------------------------------


def _per_leaf(compress, u: PyTree):
    """A flat compressor of ``core.baselines`` (``v -> (Payload, recon)``)
    on every leaf of ``u``: (recon tree, tuple of the leaves' payload
    data)."""
    leaves, treedef = tree_flatten(u)
    recs, datas = [], []
    for l in leaves:
        payload, rec = compress(l.reshape(-1))
        recs.append(rec.reshape(l.shape))
        datas.append(payload.data)
    return tree_unflatten(treedef, recs), tuple(datas)


def _scatter(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(n,) f32 zeros with ``vals`` at ``idx``."""
    return torch.zeros(n, dtype=torch.float32, device=vals.device) \
        .index_put_((idx.to(torch.int64),), vals.to(torch.float32))


@register_strategy("identity")
class IdentityStrategy(CompressionStrategy):
    """FedAvg: the update itself is the payload (4d wire bytes)."""

    def payload_floats(self, params) -> float:
        return float(sum(l.numel() for l in tree_leaves(params)))

    def client_encode(self, key, u, params):
        # recon == u exactly, so the efficiency cosine is 1 by identity
        return TreeCompressed(u, _scalar(self.payload_floats(params), u),
                              _scalar(0.0, u), cosine=_scalar(1.0, u),
                              wire=u)

    def server_decode(self, payload, params):
        return payload


@register_strategy("topk")
class TopKStrategy(CompressionStrategy):
    """DGC-style magnitude top-k per leaf: exact values + indices."""

    def payload_floats(self, params) -> float:
        return float(sum(2 * leaf_k(l.numel(), self.cfg.keep_ratio)
                         for l in tree_leaves(params)))

    def client_encode(self, key, u, params):
        # per leaf (vals, idx), in lax.top_k's order: descending |u|, a tie
        # to the lower index
        recon, wire = _per_leaf(lambda v: baselines.topk_compress(
            v, leaf_k(v.numel(), self.cfg.keep_ratio)), u)
        return TreeCompressed(recon, _scalar(self.payload_floats(params), u),
                              _scalar(0.0, u), wire=wire)

    def server_decode(self, payload, params):
        leaves, treedef = tree_flatten(params)
        out = [_scatter(leaf.numel(), idx, vals).reshape(leaf.shape)
               for (vals, idx), leaf in zip(payload, leaves)]
        return tree_unflatten(treedef, out)


@register_strategy("randk")
class RandKStrategy(CompressionStrategy):
    """Random-k per leaf (accounted-only: no wire format registered)."""

    def payload_floats(self, params) -> float:
        return float(sum(leaf_k(l.numel(), self.cfg.keep_ratio)
                         for l in tree_leaves(params)) + 1)

    def client_encode(self, key, u, params):
        # a plain tuple of index tensors is the per-leaf draws; else every
        # leaf draws from the one generator, one after another
        draws = iter(key if type(key) is tuple
                     else [key] * len(tree_leaves(u)))
        recon, _ = _per_leaf(lambda v: baselines.randk_compress(
            next(draws), v, leaf_k(v.numel(), self.cfg.keep_ratio)), u)
        return TreeCompressed(recon, _scalar(self.payload_floats(params), u),
                              _scalar(0.0, u))


@register_strategy("signsgd")
class SignSGDStrategy(CompressionStrategy):
    """signSGD with per-leaf mean-|x| scale; 1 bit/coordinate on the wire."""

    def payload_floats(self, params) -> float:
        leaves = tree_leaves(params)
        return sum(l.numel() for l in leaves) / 32.0 + len(leaves)

    def client_encode(self, key, u, params):
        recon, data = _per_leaf(baselines.signsgd_compress, u)
        # wire: the sign *source* tree + per-leaf scales; the codec packs
        # one bit per coordinate from it (bit = flush(coord) >= 0)
        scales = torch.stack([scale for _, scale in data])
        return TreeCompressed(recon, _scalar(self.payload_floats(params), u),
                              _scalar(0.0, u), wire=(u, scales))

    def server_decode(self, payload, params):
        # the canonical payload is already the reconstructed tree (signs
        # re-scaled by the codec's unpack)
        return payload


@register_strategy("stc")
class STCStrategy(CompressionStrategy):
    """STC: ternary top-k (single magnitude mu per leaf + signs)."""

    def payload_floats(self, params) -> float:
        ks = [leaf_k(l.numel(), self.cfg.keep_ratio)
              for l in tree_leaves(params)]
        return float(sum(ks)) + sum(ks) / 32.0 + len(ks)

    def client_encode(self, key, u, params):
        # per leaf (signs, idx, mu): the signs as the reference decides them
        # (subnormals flushed, a zero keeps its sign)
        recon, wire = _per_leaf(lambda v: baselines.stc_compress(
            v, leaf_k(v.numel(), self.cfg.keep_ratio)), u)
        return TreeCompressed(recon, _scalar(self.payload_floats(params), u),
                              _scalar(0.0, u), wire=wire)

    def server_decode(self, payload, params):
        leaves, treedef = tree_flatten(params)
        out = [_scatter(leaf.numel(), idx, mu * pm1)
               .reshape(leaf.shape)
               for (pm1, idx, mu), leaf in zip(payload, leaves)]
        return tree_unflatten(treedef, out)


@register_strategy("threesfc")
class ThreeSFCStrategy(CompressionStrategy):
    """The paper's method: single-step synthetic-features compression.

    The (D_syn, s) payload is the wire; the server decode is one backward
    of the global model on the synthetic batch (Eq. 10), and because every
    client encodes at the same w^t the batched payloads aggregate in one
    backward (``server_aggregate``).
    """

    supports_fused_aggregate = True

    def __init__(self, cfg, *, loss_fn=None, syn_spec=None, local_lr=0.01):
        super().__init__(cfg, loss_fn=loss_fn, syn_spec=syn_spec,
                         local_lr=local_lr)
        if syn_spec is None:
            raise ValueError(
                f"{cfg.kind} strategy needs syn_spec (synthetic payload "
                f"shapes)")

    def payload_floats(self, params) -> float:
        return self.syn_spec.floats + 1.0

    def _need_loss_fn(self) -> None:
        if self.loss_fn is None:
            raise ValueError(f"{self.cfg.kind} needs the model's syn loss_fn")

    def client_encode(self, key, u, params):
        from repro_torch.core import threesfc
        self._need_loss_fn()
        syn0 = key if isinstance(key, threesfc.SynData) \
            else threesfc.init_syn(key, self.syn_spec)
        # replicated on the model sub-mesh under tensor parallelism
        syn0 = shard.enter(syn0, shard.mesh_of(params))
        res = threesfc.encode(
            self.loss_fn, params, u, syn0,
            steps=self.cfg.syn_steps, lr=self.cfg.syn_lr,
            lam=self.cfg.l2_coef,
        )
        # encode's fused stats triple already carries cos(recon, u) and the
        # (gw, s) factorization — EF and metrics add no extra passes
        return TreeCompressed(res.recon,
                              _scalar(self.payload_floats(params), u),
                              res.objective, cosine=res.cosine,
                              direction=res.gw, scale=res.s,
                              wire=(res.syn, res.s))

    def server_decode(self, payload, params):
        from repro_torch.core import threesfc
        self._need_loss_fn()
        syn, s = payload
        return threesfc.decode(self.loss_fn, params, syn, s)

    def server_aggregate(self, params, payloads):
        """One backward over the gathered (D_syn, s):

            G(ĝ_1..ĝ_N) = ∇_w (1/N) Σ_i s_i F(D_syn,i, w^t)
        """
        from repro_torch.core import threesfc
        self._need_loss_fn()
        syns, ss = payloads
        w = flat.tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves, treedef = tree_flatten(w)
        per = torch.stack([
            self.loss_fn(w, threesfc.SynData(*[t[i] for t in syns]))
            for i in range(ss.shape[0])])
        total = torch.mean(ss.detach() * per)
        # a leaf the loss never reads gets zeros, as in threesfc.decode
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return tree_unflatten(treedef, [shard.placed_as(g, p)
                                        for g, p in zip(grads, leaves)])

    def mask_payloads(self, payloads, w):
        """(D_syn, s) is linear in s, so masking a client is s_i <- w_i s_i."""
        syns, ss = payloads
        return syns, ss * w


@register_strategy("fedsynth")
class FedSynthStrategy(ThreeSFCStrategy):
    """FedSynth baseline: K-step unrolled synthesis (accounted-only wire).

    ``opt_steps = max(syn_steps, 10)`` GD steps on ``D_syn`` at
    ``syn_lr``, each through ``unroll_steps`` simulated SGD steps at the
    clients' ``local_lr``; a ``SynData`` key is the initial ``D_syn``, as
    for 3SFC. EF is ``u − recon``; the server has no payload decode.
    """

    supports_fused_aggregate = False

    def client_encode(self, key, u, params):
        from repro_torch.core import fedsynth, threesfc
        self._need_loss_fn()
        syn0 = key if isinstance(key, threesfc.SynData) \
            else threesfc.init_syn(key, self.syn_spec)
        res = fedsynth.encode(
            self.loss_fn, params, u, syn0,
            unroll_steps=self.cfg.unroll_steps,
            opt_steps=max(self.cfg.syn_steps, 10),
            lr=self.local_lr, syn_lr=self.cfg.syn_lr,
        )
        return TreeCompressed(res.recon,
                              _scalar(self.payload_floats(params), u),
                              res.l2)

    def server_decode(self, payload, params):
        raise NotImplementedError(
            "fedsynth has no payload decode (unrolled recon is client-side)")

    def server_aggregate(self, params, payloads):
        raise NotImplementedError(
            "strategy 'fedsynth' does not support fused aggregation")
