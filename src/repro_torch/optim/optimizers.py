"""Minimal functional optimizers, the port of the JAX package's
``optim/optimizers.py``.

``make_optimizer(name, lr, **kw)`` returns ``(init_fn, update_fn)``:
    state = init_fn(params)
    params, state = update_fn(params, grads, state)
All math is done in f32 and cast back to the param dtype (bf16 params keep
an f32 view only transiently). Trees are the port's nested dicts of
tensors; ``update_fn`` returns new tensors and writes none of its inputs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

PyTree = Any
_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: PyTree           # first moment (() for sgd)
    nu: PyTree           # second moment (() unless adam)


def _device(params: PyTree) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _zeros_like_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def sgd(lr: float):
    def init(params):
        return OptState(_step0(params), (), ())

    def update(params, grads, state):
        new = tree_map(lambda p, g: (p.to(_F32) - lr * g.to(_F32)).to(
            p.dtype), params, grads)
        return new, OptState(state.step + 1, (), ())

    return init, update


def momentum(lr: float, beta: float = 0.9):
    def init(params):
        return OptState(_step0(params), _zeros_like_f32(params), ())

    def update(params, grads, state):
        mu = tree_map(lambda m, g: beta * m + g.to(_F32), state.mu, grads)
        new = tree_map(lambda p, m: (p.to(_F32) - lr * m).to(p.dtype),
                       params, mu)
        return new, OptState(state.step + 1, mu, ())

    return init, update


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return OptState(_step0(params), _zeros_like_f32(params),
                        _zeros_like_f32(params))

    def update(params, grads, state):
        t = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(_F32)), state.nu, grads)
        # the bias corrections in f32, as the reference computes them
        tf = t.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=t.device),
                            tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=t.device),
                            tf)
        new = tree_map(
            lambda p, m, v: (p.to(_F32) - lr * (m / bc1)
                             / (torch.sqrt(v / bc2) + eps)).to(p.dtype),
            params, mu, nu)
        return new, OptState(t, mu, nu)

    return init, update


def make_optimizer(name: str, lr: float, **kw) -> Tuple[Callable, Callable]:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](lr, **kw)
