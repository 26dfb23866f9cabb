"""The benchmark's inputs, made from ``--seed``: weights, tokens, batches
and the encoder's initial synthetic data.

Frozen here so that a later change to the program cannot change the
traffic: ``fold_in`` is the port's ``fl.round.fold_in`` (splitmix64), the
token set is ``data.synthetic.make_token_dataset``'s planted bigram chain,
and ``syn0`` draws what ``core.threesfc.init_syn`` draws from the
generator ``fl.round.client_generator`` seeds. The batcher is the
benchmark's own: round ``r`` gives client ``i``'s local step ``k`` the
rows ``perm[((r·N + i)·K + k)·B : ... + B]`` (mod the set's size) of one
permutation drawn from the seed, so every row of the first rounds
differs. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

_MASK64 = (1 << 64) - 1
DATA_FOLD, ROUND_FOLD, WEIGHT_FOLD, PERM_FOLD = 0, 1, 2, 3


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed from ``seed`` and integers (the port's arithmetic)."""
    x = _splitmix64(seed & _MASK64)
    for d in data:
        x = _splitmix64(x ^ _splitmix64(d & _MASK64))
    return x >> 1


def generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# --- weights -----------------------------------------------------------------
# A family lists its leaves as (path, shape, init); ``make_weights`` draws
# them all from two buffers (one normal, one uniform) in a few large calls.
#   ("fan_in", n)      truncated normal (clamped at ±2) / sqrt(n)
#   ("normal", std)    normal · std
#   ("const", c)       every element c
#   ("log_uniform", lo, hi)       log of U(lo, hi)
#   ("softplus_inv", lo, hi)      inverse softplus of exp(U(log lo, log hi))

LeafSpec = Tuple[str, Tuple[int, ...], tuple]


def make_weights(specs: Sequence[LeafSpec], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{path: f32 tensor} drawn from ``fold_in(seed, WEIGHT_FOLD)``."""
    gen = generator(device, fold_in(seed, WEIGHT_FOLD))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    normal = [i for i, (_, _, init) in enumerate(specs)
              if init[0] in ("fan_in", "normal")]
    uniform = [i for i, (_, _, init) in enumerate(specs)
               if init[0] in ("log_uniform", "softplus_inv")]
    out: Dict[str, torch.Tensor] = {}
    for group, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(sizes[i] for i in group)
        if not total:
            continue
        buf = draw((total,), generator=gen, device=device,
                   dtype=torch.float32)
        pos = 0
        for i in group:
            path, shape, init = specs[i]
            t = buf[pos:pos + sizes[i]].view(shape)
            pos += sizes[i]
            kind = init[0]
            if kind == "fan_in":
                t.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(init[1]))
            elif kind == "normal":
                t.mul_(init[1])
            elif kind == "log_uniform":
                t.mul_(init[2] - init[1]).add_(init[1]).log_()
            else:                                   # softplus_inv
                lo, hi = math.log(init[1]), math.log(init[2])
                t.mul_(hi - lo).add_(lo).exp_()
                t.copy_(t + torch.log(-torch.expm1(-t)))
            out[path] = t
    for (path, shape, init) in specs:
        if init[0] == "const":
            out[path] = torch.full(shape, float(init[1]), device=device,
                                   dtype=torch.float32)
    return {path: out[path] for path, _, _ in specs}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    root: Dict = {}
    for path, t in flat.items():
        node = root
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return root


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``: a nested dict's leaves by path."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


# --- tokens and batches ------------------------------------------------------


def make_tokens(seed: int, num_seqs: int, seq_len: int, vocab: int,
                device: torch.device, noise: float = 0.1) -> torch.Tensor:
    """(num_seqs, seq_len) int64 on ``device``: the planted bigram chain of
    ``make_token_dataset``, every draw from ``fold_in(seed, DATA_FOLD)``."""
    gen = generator(device, fold_in(seed, DATA_FOLD))
    bigram = torch.randperm(vocab, generator=gen, device=device)
    tok = torch.randint(0, vocab, (num_seqs,), generator=gen, device=device)
    seqs = [tok]
    for _ in range(seq_len - 1):
        rnd = torch.randint(0, vocab, tok.shape, generator=gen, device=device)
        use_rnd = torch.rand(tok.shape, generator=gen, device=device) < noise
        tok = torch.where(use_rnd, rnd, bigram[tok])
        seqs.append(tok)
    return torch.stack(seqs, dim=1)


class Batcher:
    """``batch_fn(data_seed, round)`` in the engine's signature: the
    (N, K, B, S) token rows of a round, the same rows for the program and
    the reference."""

    def __init__(self, tokens: torch.Tensor, seed: int, clients: int,
                 local_steps: int, batch: int):
        self.tokens = tokens
        self.n, self.k, self.b = clients, local_steps, batch
        gen = generator(tokens.device, fold_in(seed, PERM_FOLD))
        self.perm = torch.randperm(tokens.shape[0], generator=gen,
                                   device=tokens.device)

    def rows(self, rnd: int) -> torch.Tensor:
        per = self.n * self.k * self.b
        pos = torch.arange(rnd * per, (rnd + 1) * per,
                           device=self.tokens.device) % self.perm.numel()
        return self.perm[pos].view(self.n, self.k, self.b)

    def __call__(self, data_seed: int, rnd: int) -> Dict[str, torch.Tensor]:
        return {"tokens": self.tokens[self.rows(rnd)]}


# --- the encoder's initial synthetic data ------------------------------------


def syn0(seed: int, rnd: int, client: int, x_shape: Tuple[int, ...],
         label_lead: Tuple[int, ...], rank: int, classes: int,
         device: torch.device, scale: float = 0.1) -> List[torch.Tensor]:
    """[x, y, v]: what client ``client``'s encoder draws in round ``rnd``
    of an engine seeded with ``seed`` (x, then the rank-``rank`` label
    factors)."""
    key = fold_in(fold_in(seed, ROUND_FOLD), rnd)
    gen = generator(device, fold_in(key, client))

    def normal(shape):
        return scale * torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32)

    return [normal(x_shape), normal((*label_lead, rank)),
            normal((rank, classes))]
