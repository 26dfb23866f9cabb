"""Mixture-of-Experts FFN: the capacity route (top-k softmax router and
one-hot dispatch) and the dropless route (sigmoid router, grouped
products).

**The capacity route** (``moe_ffn``; the JAX twins' MoE configs).

The JAX package's ``models/moe.py``: the router runs in f32 and keeps the
top k of the softmax (ties to the lower expert index, as ``lax.top_k``),
renormalized; the Switch aux loss is taken from the top-1 choice. Each
(token, slot) takes the next place in its expert's queue of capacity
``C = max(1, int(capacity_factor · k · S / E))``; those past it are
dropped (the residual carries them). The dispatch and combine one-hots
are (B, S, E, C), folded over the k slots (written folded: the
reference's unfolded (B, S·k, E, C) ones are k times larger); the
experts' SwiGLU runs as three (E, ...) batched products, and optional
shared experts as one dense SwiGLU of width ``d_ff · shared_experts``
added to the routed output.

**The dropless route** (``moe_dropless``; DeepSeek-V3's ``noaux_tc`` with
one group, ``router="sigmoid"``). The router's f32 sigmoid scores over all
E experts; each token's k experts are the top k of score + ``score_bias``
(stable order, a tie to the lower index), weighted by their bare scores
normalised over the k and times ``routed_scaling_factor``. The bias
steers the choice alone: it enters the graph through a zero product, so
its gradient is zero (not missing). No capacity, nothing dropped, no
auxiliary loss.

Under expert parallelism a layer holds the experts ``[lo, lo + n)`` of
the E (``w_in``/``w_gate``/``w_out`` with n rows) and computes only their
part of the output: the (token, slot) pairs routed to a held expert,
sorted by expert into a static (T·k, d) buffer whose first rows are
held, run once through each held expert's SwiGLU by three grouped
products (``torch._grouped_mm`` over the held offsets: work in proportion
to the held slots); each token then gathers its k slot outputs, zero for
a slot outside the held experts, weighs and sums them in f32 (a gather
and a sum over k: no atomic adds). Shapes never depend on the data and
nothing is read back to the host. ``_grouped_mm`` leaves the rows past
the last offset unwritten in the forward and gives them a nonzero
gradient in the double backward, so every buffer it reads is cut to the
held rows by ``where`` (never a view of x, never a multiply, which would
carry a NaN through).

Each call's routed part is one ``moe.routed`` span (``obs.layer_span``);
it counts its slots, ``moe.slots``, and each held expert's,
``moe.slots.held.<j>`` (``obs.layer_count``, on the device).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import params as P_
from repro_torch.models import shard
from repro_torch.obs import layer_count, layer_span


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor    # load-balance loss (Switch-style)


def moe_init(gen: torch.Generator, d: int, ff: int, num_experts: int,
             shared_experts: int = 0, dtype=torch.float32, *,
             held: int = 0, score_bias: bool = False) -> Dict:
    """``held`` experts' weights (0: all ``num_experts``); the router stays
    ``num_experts`` wide. ``score_bias``: the dropless route's (E,) f32
    selection bias, zeros."""
    n = held or num_experts
    p = {
        "router": P_.dense_init(gen, d, (d, num_experts), torch.float32),
        "w_in": P_.dense_init(gen, d, (n, d, ff), dtype),
        "w_gate": P_.dense_init(gen, d, (n, d, ff), dtype),
        "w_out": P_.dense_init(gen, ff, (n, ff, d), dtype),
    }
    if score_bias:
        p["score_bias"] = torch.zeros((num_experts,), dtype=torch.float32,
                                      device=gen.device)
    if shared_experts:
        p["shared"] = layers.ffn_init(gen, d, ff * shared_experts, dtype)
    return p


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values and indices in descending
    order, a tie to the lower index (a stable sort; ``torch.topk`` leaves
    the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p: Dict, x: torch.Tensor, k: int):
    """Returns (top-k weights (B, S, k), top-k expert ids (B, S, k), aux
    loss)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)
    # Switch aux loss: E · Σ_e fraction_tokens(e) · mean_prob(e)
    E = logits.shape[-1]
    me = torch.mean(probs, dim=(0, 1))                               # (E,)
    onehot = F.one_hot(top_e[..., 0], E).to(torch.float32)  # top-1 assign
    ce = torch.mean(onehot, dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return top_w, top_e, aux


def capacity(capacity_factor: float, k: int, S: int, E: int) -> int:
    """Each expert's queue length, in the reference's Python arithmetic."""
    return max(1, int(capacity_factor * k * S / E))


def dispatch_combine(top_w: torch.Tensor, top_e: torch.Tensor, E: int,
                     C: int):
    """The (B, S, E, C) dispatch and combine one-hots, folded over the k
    slots: a (token, slot) takes the next place in its expert's queue in
    (token, slot) order, and is dropped past C. A token's k experts are
    distinct, so each (token, expert) has at most one place: the folded
    one-hots are written in place of the reference's (B, S·k, E, C) ones
    and their sum over k, with the same bits."""
    B, S, k = top_e.shape
    e = top_e.reshape(B, S * k)
    flat = F.one_hot(e, E).to(torch.float32)                    # (B,S·k,E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat) * flat
    pos = torch.gather(pos_in_e, 2, e[..., None])[..., 0].long()  # (B,S·k)
    # each kept (token, slot)'s element of the flat (B, S, E, C) one-hots;
    # a dropped one's is a spare element past them, so no write takes a
    # shape that depends on the data (selecting the kept ones would read
    # their count back to the host)
    n = B * S * E * C
    b = torch.arange(B, device=e.device)[:, None]
    s = torch.arange(S * k, device=e.device)[None, :] // k
    where = torch.where(pos < C, ((b * S + s) * E + e) * C + pos,
                        n).reshape(-1)
    dispatch = top_w.new_zeros(n + 1).scatter(
        0, where, top_w.new_ones(where.shape))
    combine = top_w.new_zeros(n + 1).scatter(0, where, top_w.reshape(-1))
    return (dispatch[:n].reshape(B, S, E, C),
            combine[:n].reshape(B, S, E, C))


def _experts(p: Dict, xe: torch.Tensor, combine: torch.Tensor
             ) -> torch.Tensor:
    """The experts' SwiGLU on their queues, combined back onto tokens."""
    dt = xe.dtype
    h = torch.einsum("ebcd,edf->ebcf", xe, p["w_in"].to(dt))
    g = torch.einsum("ebcd,edf->ebcf", xe, p["w_gate"].to(dt))
    ye = torch.einsum("ebcf,efd->ebcd", F.silu(g) * h, p["w_out"].to(dt))
    return torch.einsum("ebcd,bsec->bsd", ye, combine)


def _expert_split(p: Dict):
    """How tensor parallelism splits the expert weights: ``"experts"``
    (each rank holds whole experts) or ``"ff"`` (each expert's ff slice,
    the rules' fallback when the experts do not divide the model axis);
    ``None`` for plain weights or any other layout."""
    w_in, w_gate, w_out = p["w_in"], p["w_gate"], p["w_out"]
    if not all(shard.is_dtensor(w) for w in (w_in, w_gate, w_out)):
        return None
    from torch.distributed.tensor import Shard
    dims = tuple(w.placements[0] for w in (w_in, w_gate, w_out))
    if dims == (Shard(0), Shard(0), Shard(0)):
        return "experts"
    if dims == (Shard(2), Shard(2), Shard(1)):
        return "ff"
    return None


def _experts_local(p: Dict, xe: torch.Tensor, combine: torch.Tensor,
                   split: str) -> torch.Tensor:
    """``_experts`` with sharded expert weights, each rank on what it
    holds: its experts' queues (``"experts"``) or every queue through its
    ff slice (``"ff"``). Either way a rank's output is a partial sum over
    experts or ff, reduced by one all-reduce; xe's gradient is the matching
    partial sum."""
    from torch.distributed.tensor import Shard
    mesh = p["w_in"].device_mesh
    xe, combine = shard.enter((xe, combine), mesh)
    pinned = split == "experts" and xe.placements[0] == Shard(0)
    xl = shard.local_shard(shard.replicate(xe) if not pinned else xe,
                           partial_grad=not pinned)
    cl = shard.local_shard(shard.replicate(combine), partial_grad=True)
    if split == "experts":
        e = p["w_in"].to_local().shape[0]
        lo = mesh.get_local_rank() * e
        if xl.shape[0] != e:
            xl = xl[lo:lo + e]
        cl = cl[:, :, lo:lo + e]
    local = {k: shard.local_shard(p[k]) for k in ("w_in", "w_gate", "w_out")}
    return shard.reduce_partial(_experts(local, xl, cl), mesh)


def moe_ffn(p: Dict, x: torch.Tensor, *, experts_per_token: int,
            capacity_factor: float = 1.25, aux_coef: float = 0.01) -> MoEOut:
    """x: (B, S, d) -> (B, S, d)."""
    S = x.shape[1]
    E = p["router"].shape[-1]
    k = experts_per_token
    top_w, top_e, aux = _router(p, x, k)
    dispatch, combine = dispatch_combine(
        top_w, top_e, E, capacity(capacity_factor, k, S, E))

    dt = x.dtype
    xe = torch.einsum("bsd,bsec->ebcd", x, dispatch.to(dt))        # (E,B,C,d)
    xe = shard.heads(xe, axis=0)       # opt-in pin: experts on 'model'
    split = _expert_split(p)
    if split is not None:
        y = _experts_local(p, xe, combine.to(dt), split)
    else:
        y = _experts(p, xe, combine.to(dt))
    if "shared" in p:
        y = y + layers.ffn(p["shared"], x)
    return MoEOut(y, aux_coef * aux)


# ---------------------------------------------------------------------------
# the dropless route
# ---------------------------------------------------------------------------


def sigmoid_route(p: Dict, x: torch.Tensor, k: int, scaling: float):
    """(weights (.., k) f32, experts (.., k) int64) of x (.., d): the top
    k of sigmoid score + ``score_bias``, weighted by the bare scores
    normalised over the k, times ``scaling``."""
    bias = p["score_bias"]
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    # + 0·bias: the bias in the graph with a zero gradient
    scores = torch.sigmoid(logits) + 0.0 * bias
    _, top_e = top_k(scores.detach() + bias.detach(), k)
    w = torch.gather(scores, -1, top_e)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20) * scaling
    return w, top_e


def held_layout(top_e: torch.Tensor, lo: int, n: int):
    """The static sort of T·k (token, slot) pairs by held expert.

    ``top_e`` (T, k) -> (order (T·k,): the slots in row order, held first
    by expert then in (token, slot) order; slot_row (T·k,): each slot's
    row, its inverse; offs (n,) int32: the held rows' cumulative ends;
    counts (n,): each held expert's slots)."""
    j = top_e.reshape(-1) - lo
    key = torch.where((j >= 0) & (j < n), j, n)
    order = torch.argsort(key, stable=True)
    slot_row = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    counts = torch.sum(key[:, None] == torch.arange(n, device=key.device),
                       dim=0)
    offs = torch.cumsum(counts, dim=0).to(torch.int32)
    return order, slot_row, offs, counts


def grouped_swiglu(a: torch.Tensor, p: Dict, offs: torch.Tensor
                   ) -> torch.Tensor:
    """Rows ``a`` (R, d), sorted by held expert, through each one's SwiGLU:
    rows ``[offs[j-1], offs[j])`` by expert j; rows past ``offs[-1]`` come
    out zero, with zero gradient of every order (the input and each
    product's output cut to the held rows by ``where``)."""
    dt = a.dtype
    held = (torch.arange(a.shape[0], device=a.device)
            < offs[-1])[:, None]
    zero = a.new_zeros(())

    def mm(t, w):
        return torch.where(held, torch._grouped_mm(t, w.to(dt), offs), zero)

    a = torch.where(held, a, zero)
    return mm(F.silu(mm(a, p["w_gate"])) * mm(a, p["w_in"]), p["w_out"])


def routed_experts(p: Dict, x: torch.Tensor, *, experts_per_token: int,
                   scaling: float, held_start: int = 0) -> torch.Tensor:
    """The held experts' part of the routed output, x (B, S, d) ->
    (B, S, d)."""
    if _expert_split(p) is not None or shard.is_dtensor(x):
        raise NotImplementedError(
            "the dropless route runs on plain tensors only (no tensor "
            "parallelism)")
    with layer_span("moe.routed", x):
        k, n = experts_per_token, p["w_in"].shape[0]
        xt = x.reshape(-1, x.shape[-1])
        w, top_e = sigmoid_route(p, xt, k, scaling)
        order, slot_row, offs, counts = held_layout(top_e, held_start, n)
        layer_count("moe.slots", top_e.numel(), x)
        layer_count("moe.slots.held", counts, x)
        y = grouped_swiglu(xt[order // k], p, offs)
        slots = y[slot_row].view(*top_e.shape, -1).to(torch.float32)
        out = torch.sum(slots * w[..., None], dim=-2)
        return out.to(x.dtype).view(x.shape)


def moe_dropless(p: Dict, x: torch.Tensor, *, experts_per_token: int,
                 scaling: float, held_start: int = 0) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the held routed experts' part plus the
    shared experts (one SwiGLU)."""
    y = routed_experts(p, x, experts_per_token=experts_per_token,
                       scaling=scaling, held_start=held_start)
    if "shared" in p:
        y = y + layers.ffn(p["shared"], x)
    return y
