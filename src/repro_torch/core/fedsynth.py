"""FedSynth-style multi-step distillation baseline (what 3SFC fixes).

The port of the JAX package's ``core/fedsynth.py``. The method of Goetz &
Tewari / Hu et al.: synthesize data such that *K unrolled SGD steps* on the
synthetic batch, starting from ``w^t``, land near the true local weights
``w_i^t``. The objective is the ℓ₂ distance between simulated and real
weights, differentiated through the whole unroll (grad-through-K-grads).

The paper shows (Fig. 2/3, Table 1) this collapses at high compression on
non-trivial models: gradients through the unroll explode as they
backpropagate to the early simulation steps. ``syn_grad_norm`` surfaces
the syn-grad norm of the last optimization step so the explosion is
observable.

The reference's ``lax.scan`` over the K steps is a Python loop of
``torch.autograd.grad(..., create_graph=True)`` here, so the objective's
gradient to ``D_syn`` runs back through every simulated step; the
optimization loop detaches ``D_syn`` between its steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import flat
from repro_torch.core.threesfc import LossFn, SynData
from repro_torch.core.tree import PyTree, tree_flatten, tree_unflatten
from repro_torch.kernels import causal_attention


class FedSynthResult(NamedTuple):
    syn: SynData
    recon: PyTree                    # w^t - simulate(syn) : the decoded update
    l2: torch.Tensor                 # final objective value
    syn_grad_norm: torch.Tensor      # grad-through-unroll norm (explosion metric)


def _simulate(loss_fn: LossFn, params: PyTree, syn: SynData, k: int,
              lr: float, *, create_graph: bool = False) -> PyTree:
    """K unrolled SGD steps on the synthetic batch from ``params`` (whose
    leaves require grad). ``create_graph`` keeps each step's graph for a
    backward to ``syn`` through the unroll."""
    w = params
    for _ in range(k):
        leaves, treedef = tree_flatten(w)
        # a leaf the loss never reads gets zeros, as jax.grad reports it
        g = torch.autograd.grad(loss_fn(w, syn), leaves,
                                create_graph=create_graph,
                                allow_unused=True, materialize_grads=True)
        w = flat.tree_axpy(-lr, tree_unflatten(treedef, list(g)), w)
    return w


def _leaf_params(params: PyTree) -> PyTree:
    return flat.tree_map(lambda p: p.detach().requires_grad_(True), params)


def encode(
    loss_fn: LossFn,
    params: PyTree,
    target: PyTree,                  # g_i^t = w^t - w_i^t
    syn0: SynData,
    *,
    unroll_steps: int = 5,
    opt_steps: int = 10,
    lr: float = 0.01,
    syn_lr: float = 0.1,
) -> FedSynthResult:
    """Optimize syn data so the K-step simulated update matches ``target``
    (``opt_steps`` plain GD steps of size ``syn_lr``; at least one)."""
    if opt_steps < 1:
        raise ValueError(f"fedsynth encode needs opt_steps >= 1, got "
                         f"{opt_steps}")
    w = _leaf_params(params)
    target = flat.tree_map(torch.Tensor.detach, target)

    def objective(syn: SynData) -> torch.Tensor:
        w_sim = _simulate(loss_fn, w, syn, unroll_steps, lr,
                          create_graph=True)
        sim_update = flat.tree_sub(w, w_sim)                 # w^t - w_sim
        return flat.tree_sqnorm(flat.tree_sub(sim_update, target))

    syn = SynData(*[t.detach() for t in syn0])
    gnorm = None
    for _ in range(opt_steps):
        syn_v = SynData(*[t.detach().requires_grad_(True) for t in syn])
        # grad-through-grads: attention keeps its twice-differentiable
        # route, in the backwards too (the remat runs the forwards again)
        with causal_attention.second_order():
            g = torch.autograd.grad(objective(syn_v), list(syn_v),
                                    allow_unused=True)
        # an input the loss never reads (dense labels' empty y_rank) has a
        # zero gradient, as jax.grad reports it
        g = [torch.zeros_like(p) if gi is None else gi
             for p, gi in zip(syn, g)]
        with torch.no_grad():
            gnorm = flat.tree_norm(g)
            syn = SynData(*[p - syn_lr * gi for p, gi in zip(syn, g)])

    recon = decode(loss_fn, params, syn, unroll_steps, lr)
    l2 = flat.tree_sqnorm(flat.tree_sub(recon, target))
    return FedSynthResult(syn, recon, l2, gnorm)


def decode(loss_fn: LossFn, params: PyTree, syn: SynData, k: int,
           lr: float) -> PyTree:
    """w^t − simulate(syn): the update K SGD steps on ``syn`` make."""
    w = _leaf_params(params)
    w_sim = _simulate(loss_fn, w, syn, k, lr)
    return flat.tree_map(torch.Tensor.detach, flat.tree_sub(w, w_sim))
