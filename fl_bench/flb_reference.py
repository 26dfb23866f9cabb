"""The plain reference of a federated 3SFC round, family-independent.

Written from the paper (3SFC, Algorithm 1 with error feedback) and the
configuration, in plain PyTorch over a flat ``{path: tensor}`` parameter
dict; the model is a family's ``Reference`` (``families/<family>.py``).
It imports nothing of the program. A round, for each client ``i``:

1. K local SGD steps at ``lr`` on its batch, each step's gradient the
   mean over ``num_micro`` slices of the batch (the configuration's
   microbatch rule), the LM loss next-token cross-entropy over chunks of
   512 positions; ``g = w − w_local`` (f32);
2. ``u = g + e_i``; the encode: from ``syn0`` (soft input embeddings x,
   rank-r soft-label factors y, v), S steps of gradient descent on
   ``1 − |cos(∇_w F(syn, w), u)|``, each step divided by the RMS of its
   gradient, then ``s = ⟨∇F, u⟩ / ‖∇F‖²``;
3. the residual ``e_i' = u − s·∇F`` and the reconstruction ``s·∇F``;

then the server's ``w' = w − mean_i(s_i·∇F_i)``. A round reports the
clients' mean loss, each client's cosine ``sign(s)·cos(∇F, u)``, the
aggregate's norm, each residual's norm by leaf and the floats a client
sends (the synthetic sample and s).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
LOSS_CHUNK = 512
EPS = 1e-12


def rmsnorm(x, scale, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def num_micro(per_client: int, seq_len: int) -> int:
    """The configuration's microbatch rule: from 4,096 tokens a sequence,
    ``min(per_client, 8)`` slices, lowered to a divisor; else one."""
    n = min(per_client, 8) if seq_len >= 4096 else 1
    while per_client % n:
        n -= 1
    return n


def lm_loss(model, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; each layer and each chunk of the
    head recomputed in the backward."""
    S = tokens.shape[1]
    h = model.trunk(p, model.embed(p, tokens), remat=True)[:, :-1]
    targets = tokens[:, 1:]

    def ce(hc, tc):
        logp = torch.log_softmax(model.logits(p, hc), dim=-1)
        return -torch.sum(torch.gather(logp, -1, tc[..., None]))

    chunk = min(LOSS_CHUNK, S - 1)
    tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for start in range(0, S - 1, chunk):
        sl = slice(start, start + chunk)
        tot = tot + checkpoint(ce, h[:, sl], targets[:, sl],
                               use_reentrant=False)
    return tot / float(targets.numel())


def syn_loss(model, p: Params, x, y, v) -> torch.Tensor:
    """Soft-label cross-entropy of the synthetic sample (the encoder's F):
    labels ``softmax(y·v)`` over the vocabulary."""
    h = model.trunk(p, x.to(model.dt), remat=False)
    logp = torch.log_softmax(model.logits(p, h).to(torch.float32), dim=-1)
    target = torch.softmax(torch.einsum("...r,rc->...c", y, v), dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))


def value_and_grad(fn: Callable, p: Params, *args):
    w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    val = fn(w, *args)
    grads = torch.autograd.grad(val, list(w.values()))
    return val.detach(), dict(zip(w, grads))


def local_train(model, p0: Params, batches: torch.Tensor, lr: float,
                micro: int):
    """``batches`` (K, B, S): (g, mean loss)."""
    w = {k: t.detach() for k, t in p0.items()}
    losses = []
    for k in range(batches.shape[0]):
        batch = batches[k]
        mb = batch.shape[0] // micro
        tot = torch.zeros((), dtype=torch.float32, device=batch.device)
        acc = {n: torch.zeros_like(t, dtype=torch.float32)
               for n, t in w.items()}
        for i in range(micro):
            v, g = value_and_grad(lambda q, b: lm_loss(model, q, b), w,
                                  batch[i * mb:(i + 1) * mb])
            tot = tot + v
            acc = {n: acc[n] + g[n] for n in acc}
        grad = {n: a * (1.0 / micro) for n, a in acc.items()}
        w = {n: (w[n].to(torch.float32) - lr * grad[n]).to(w[n].dtype)
             for n in w}
        losses.append(tot * (1.0 / micro))
    g = {n: (p0[n].detach() - w[n]).to(torch.float32) for n in p0}
    return g, torch.mean(torch.stack(losses))


def _stats(gw: List[torch.Tensor], u: List[torch.Tensor]):
    dot = sum(torch.sum(a.to(torch.float32) * b) for a, b in zip(gw, u))
    gg = sum(torch.sum(torch.square(a.to(torch.float32))) for a in gw)
    tt = sum(torch.sum(torch.square(b)) for b in u)
    return dot, gg, tt


def encode(model, p: Params, u: Params, syn0: List[torch.Tensor],
           steps: int, lr: float):
    """(s, ∇_w F at the final syn, cosine)."""
    w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    leaves = list(w.values())
    target = [u[k] for k in w]

    def objective(syn, create_graph):
        val = syn_loss(model, w, *syn)
        gw = torch.autograd.grad(val, leaves, create_graph=create_graph,
                                 allow_unused=True, materialize_grads=True)
        dot, gg, tt = _stats(gw, target)
        cos = dot / (torch.sqrt(gg) * torch.sqrt(tt) + EPS)
        return 1.0 - torch.abs(cos), gw, (dot, gg, tt)

    syn = [t.detach() for t in syn0]
    for _ in range(steps):
        sv = [t.detach().requires_grad_(True) for t in syn]
        val, _, _ = objective(sv, True)
        gs = torch.autograd.grad(val, sv, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for t, g in zip(sv, gs)]
        with torch.no_grad():
            syn = [t - lr * g / torch.sqrt(torch.mean(g * g) + EPS)
                   for t, g in zip(syn, gs)]
    _, gw, (dot, gg, tt) = objective(syn, False)
    s = dot / (gg + EPS)
    cos = torch.sign(s) * dot / (torch.sqrt(gg) * torch.sqrt(tt) + EPS)
    return s.detach(), dict(zip(w, (g.detach() for g in gw))), cos.detach()


def leaf_norms(tree: Params) -> Dict[str, float]:
    names = sorted(tree)
    vals = torch.stack([torch.linalg.vector_norm(tree[n].to(torch.float32))
                        for n in names]).tolist()
    return dict(zip(names, vals))


def run_round(model, p: Params, ef: List[Params], batches: torch.Tensor,
              syn0s: List[List[torch.Tensor]], traffic: Dict,
              micro: int, fault: Optional[str] = None):
    """One round. ``batches`` (N, K, B, S); returns (new params, new EF,
    record). ``fault`` plants one of the faults a check must catch:
    ``'half_batch'`` (each step's loss over half of its batch),
    ``'one_answer'`` (client 0's reconstruction doubled)."""
    N = batches.shape[0]
    lr = traffic["lr"]
    if fault == "half_batch":
        half = batches.shape[2] // 2
        batches = batches[:, :, :half]
        micro = num_micro(half, batches.shape[-1])
    agg = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in p.items()}
    losses, cos, new_ef, ef_norms = [], [], [], []
    for i in range(N):
        g, loss = local_train(model, p, batches[i], lr, micro)
        u = {k: g[k] + ef[i][k] for k in g}
        del g
        s, gw, c = encode(model, p, u, syn0s[i], traffic["syn_steps"],
                          traffic["syn_lr"])
        e = {k: u[k] - s * gw[k] for k in u}
        scale = 2.0 * s if (fault == "one_answer" and i == 0) else s
        for k in agg:
            agg[k] += scale * gw[k]
        del u, gw
        new_ef.append(e)
        ef_norms.append(leaf_norms(e))
        losses.append(loss)
        cos.append(c)
    agg = {k: a / N for k, a in agg.items()}
    upd = torch.sqrt(sum(torch.sum(a * a) for a in agg.values()))
    new_p = {k: (t.to(torch.float32) - agg[k]).to(t.dtype)
             for k, t in p.items()}
    rec = {"loss": float(torch.mean(torch.stack(losses))),
           "cosine": torch.stack(cos).tolist(),
           "update_norm": float(upd), "ef": ef_norms,
           "payload": float(sum(t.numel() for t in syn0s[0]) + 1)}
    return new_p, new_ef, rec
