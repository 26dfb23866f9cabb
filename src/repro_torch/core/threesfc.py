"""3SFC — Single-Step Synthetic Features Compressor (the paper's method).

Encoder (client, Eq. 7-9): compress the accumulated local update ``g + e``
into a tiny synthetic dataset ``D_syn = (x_syn, y_syn)`` plus one scalar
``s`` by maximizing |cos(∇_w F(D_syn, w^t), g+e)|. The scale is factored
out analytically (Eq. 8), ``s = <g+e, ∇F> / ‖∇F‖²``, so the synthetic-data
objective (Eq. 9) only cares about direction:

    min_{D_syn}  1 - |cos(∇_w F(D_syn, w^t), g+e)| + λ ‖D_syn‖²

optimized for S steps of GD through grad-of-grad. Decoder (server, Eq. 10):
one backward of the global model on ``D_syn`` scaled by ``s``. Both sides
evaluate at the same ``w^t``, so the reconstruction is exact on the server.

Every objective evaluation reduces the gradient trees once, through kernel
B1 (``flat.tree_stats``); Eq. 8's scale, the efficiency cosine and the
Eq. 9 value are scalar algebra on that one triple.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import flat
from repro_torch.core.tree import PyTree, tree_flatten, tree_unflatten
from repro_torch.kernels import causal_attention
from repro_torch.models import shard


class SynData(NamedTuple):
    """The transmitted synthetic dataset. ``y_rank`` empty => dense labels."""

    x: torch.Tensor                  # synthetic inputs
    y: torch.Tensor                  # soft label logits, dense or factor u
    y_rank: torch.Tensor             # low-rank factor v (r, C); (0, 0) if dense

    @property
    def floats(self) -> float:
        return float(self.x.numel() + self.y.numel() + self.y_rank.numel())

    def labels(self) -> torch.Tensor:
        """Dense soft-label logits."""
        if self.y_rank.numel() == 0:
            return self.y
        return torch.einsum("...r,rc->...c", self.y, self.y_rank)


@dataclasses.dataclass(frozen=True)
class SynSpec:
    """Static description of the synthetic payload's shapes."""

    x_shape: Tuple[int, ...]         # e.g. (n, 28, 28, 1)
    num_classes: int
    label_rank: int = 0              # 0 => dense (n, ..., C) labels
    label_lead: Tuple[int, ...] = () # leading label dims, default x_shape[:1]

    @property
    def floats(self) -> float:
        lead = self.label_lead or self.x_shape[:1]
        x = float(np.prod(self.x_shape))
        if self.label_rank:
            return (x + float(np.prod(lead)) * self.label_rank
                    + self.label_rank * self.num_classes)
        return x + float(np.prod(lead)) * self.num_classes


def init_syn(gen: torch.Generator, spec: SynSpec, scale: float = 0.1
             ) -> SynData:
    """A fresh ``D_syn`` drawn from ``gen``, on the generator's device."""
    dev = gen.device

    def normal(shape):
        return scale * torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32)

    x = normal(spec.x_shape)
    lead = spec.label_lead or spec.x_shape[:1]
    if spec.label_rank:
        y = normal((*lead, spec.label_rank))
        v = normal((spec.label_rank, spec.num_classes))
    else:
        y = normal((*lead, spec.num_classes))
        v = torch.zeros((0, 0), dtype=torch.float32, device=dev)
    return SynData(x, y, v)


# ``loss_fn(params, syn: SynData) -> scalar`` — the model's empirical risk on
# the synthetic batch (soft-label cross-entropy).
LossFn = Callable[[PyTree, SynData], torch.Tensor]


def soft_xent(logits: torch.Tensor, label_logits: torch.Tensor
              ) -> torch.Tensor:
    """Cross-entropy against softmax(label_logits); mean over leading dims."""
    target = torch.softmax(label_logits, dim=-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))


_EPS = 1e-12


def _grad_params(loss_fn: LossFn, params: PyTree, syn: SynData, *,
                 create_graph: bool) -> PyTree:
    """∇_w loss_fn(w, syn) at ``params`` (whose leaves require grad). A
    leaf the loss never reads (an untied input embedding under soft
    embeddings) gets a zero gradient, as ``jax.grad`` reports it."""
    leaves, treedef = tree_flatten(params)
    loss = loss_fn(params, syn)
    grads = torch.autograd.grad(loss, leaves, create_graph=create_graph,
                                allow_unused=True, materialize_grads=True)
    return tree_unflatten(treedef, [shard.placed_as(g, p)
                                    for g, p in zip(grads, leaves)])


def _objective(loss_fn: LossFn, params: PyTree, syn: SynData,
               target: PyTree, lam: float, *, create_graph: bool = False
               ) -> Tuple[torch.Tensor, Tuple[PyTree, torch.Tensor]]:
    """Eq. 9 value plus aux ``(gw, stats)``; ``stats = (⟨gw,t⟩, ‖gw‖²,
    ‖t‖²)`` comes from one fused pass (kernel B1). ``create_graph`` keeps
    the graph for a backward to ``syn`` (grad-of-grad)."""
    gw = _grad_params(loss_fn, params, syn, create_graph=create_graph)
    stats = flat.tree_stats(gw, target)
    dot, gg, tt = stats[0], stats[1], stats[2]
    cos = dot / (torch.sqrt(gg) * torch.sqrt(tt) + _EPS)
    reg = lam * flat.tree_sqnorm([syn.x, syn.y, syn.y_rank])
    return 1.0 - torch.abs(cos) + reg, (gw, stats)


class EncodeResult(NamedTuple):
    syn: SynData
    s: torch.Tensor                  # scaling coefficient (Eq. 8)
    gw: PyTree                       # ∇_w F(D_syn, w^t) at the final D_syn
    cosine: torch.Tensor             # compression efficiency (Fig. 7 metric)
    objective: torch.Tensor          # final Eq. 9 value
    stats: torch.Tensor              # (⟨gw,t⟩, ‖gw‖², ‖t‖²) fused triple

    @property
    def recon(self) -> PyTree:
        """s · ∇_w F(D_syn, w^t) — what the server sees (Eq. 10)."""
        return flat.tree_scale(self.gw, self.s)


def encode(
    loss_fn: LossFn,
    params: PyTree,
    target: PyTree,
    syn0: SynData,
    *,
    steps: int = 1,
    lr: float = 0.1,
    lam: float = 0.0,
    normalize_updates: bool = True,
) -> EncodeResult:
    """Run S optimization steps on D_syn (Algorithm 1 lines 7-9), then Eq. 8.

    ``normalize_updates=True`` rescales each GD step by the syn-grad RMS,
    as the reference does; ``False`` is the paper's plain GD.

    Steps 0..S-1 each evaluate the objective with the graph kept and take
    its gradient to ``D_syn`` (grad-of-grad); one more forward-only
    evaluation at the returned ``D_syn`` gives (objective, gw, stats). That
    is S+1 evaluations, one B1 launch each for a model under 4 Mi
    parameters.
    """
    w = flat.tree_map(lambda p: p.detach().requires_grad_(True), params)
    target = flat.tree_map(torch.Tensor.detach, target)

    def update(syn: SynData, g) -> SynData:
        if normalize_updates:
            def upd(p, gi):
                rms = torch.sqrt(torch.mean(gi * gi) + 1e-12)
                return p - lr * gi / rms
            return SynData(*[upd(p, gi) for p, gi in zip(syn, g)])
        return SynData(*[p - lr * gi for p, gi in zip(syn, g)])

    syn = SynData(*[t.detach() for t in syn0])
    for _ in range(steps):
        syn_v = SynData(*[t.detach().requires_grad_(True) for t in syn])
        # grad-of-grad: attention keeps its twice-differentiable route, in
        # the backwards too (the remat runs the forwards again there)
        with causal_attention.second_order():
            val, _ = _objective(loss_fn, w, syn_v, target, lam,
                                create_graph=True)
            g = torch.autograd.grad(val, list(syn_v), allow_unused=True)
        # an input the loss never reads (dense labels' empty y_rank) has a
        # zero gradient, as jax.grad reports it
        g = [torch.zeros_like(p) if gi is None else shard.placed_as(gi, p)
             for p, gi in zip(syn, g)]
        with torch.no_grad():
            syn = update(syn, g)
    val, (gw, stats) = _objective(loss_fn, w, syn, target, lam)
    gw = flat.tree_map(torch.Tensor.detach, gw)
    val, stats = val.detach(), stats.detach()

    dot, gg = stats[0], stats[1]
    s = dot / (gg + _EPS)                                    # Eq. 8
    # cos(s·gw, target) = sign(s) · cos(gw, target), from the same triple
    cos = torch.sign(s) * dot / (torch.sqrt(gg) * torch.sqrt(stats[2]) + _EPS)
    return EncodeResult(syn, s, gw, cos, val, stats)


def decode(loss_fn: LossFn, params: PyTree, syn: SynData,
           s: torch.Tensor) -> PyTree:
    """Server-side reconstruction (Eq. 10): s · ∇_w F(D_syn, w^t)."""
    w = flat.tree_map(lambda p: p.detach().requires_grad_(True), params)
    gw = _grad_params(loss_fn, w, syn, create_graph=False)
    return flat.tree_scale(gw, s)
