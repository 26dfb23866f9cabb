"""The paper's vision models; this slice ports the MLP.

* MLP — 784-200-200-10 (199,210 params, matching the paper's count)

The facade matches the JAX package's: ``init(gen)``, ``apply(params, x) ->
logits``, ``loss(params, batch)`` (softmax CE on int labels) and
``syn_loss(params, syn)`` (soft-label CE on synthetic pixels — the 3SFC
payload for classifiers). Params are plain nested dicts of tensors and
``apply`` is functional, because 3SFC needs ∇_w of a loss at explicit
params with the graph kept.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.threesfc import SynData, soft_xent
from repro_torch.models.params import dense_init

PyTree = Any


class VisionSpec(NamedTuple):
    name: str
    input_shape: Tuple[int, int, int]     # (H, W, C)
    num_classes: int


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None],
                                            dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


class VisionModel:
    """Facade wrapping an (init_fn, apply_fn) pair."""

    def __init__(self, spec: VisionSpec, init_fn, apply_fn):
        self.spec = spec
        self._init = init_fn
        self._apply = apply_fn

    def init(self, gen: torch.Generator) -> PyTree:
        """Fresh params drawn from ``gen``, on the generator's device."""
        return self._init(gen)

    def apply(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        return self._apply(params, x)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        return xent(self._apply(params, batch["x"]), batch["y"])

    def syn_loss(self, params: PyTree, syn: SynData) -> torch.Tensor:
        return soft_xent(self._apply(params, syn.x), syn.labels())


# ---------------------------------------------------------------------------
# MLP — 784-200-200-10 = 199,210 params (paper Fig. 1)
# ---------------------------------------------------------------------------


def make_mlp(spec: VisionSpec, hidden: int = 200) -> VisionModel:
    d_in = int(np.prod(spec.input_shape))

    def init(gen):
        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=gen.device)

        return {
            "l1": {"w": dense_init(gen, d_in, (d_in, hidden)),
                   "b": zeros(hidden)},
            "l2": {"w": dense_init(gen, hidden, (hidden, hidden)),
                   "b": zeros(hidden)},
            "l3": {"w": dense_init(gen, hidden, (hidden, spec.num_classes)),
                   "b": zeros(spec.num_classes)},
        }

    def apply(p, x):
        h = x.reshape(x.shape[0], -1)
        h = torch.relu(h @ p["l1"]["w"] + p["l1"]["b"])
        h = torch.relu(h @ p["l2"]["w"] + p["l2"]["b"])
        return h @ p["l3"]["w"] + p["l3"]["b"]

    return VisionModel(spec, init, apply)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

MNIST_SPEC = VisionSpec("mnist", (28, 28, 1), 10)
EMNIST_SPEC = VisionSpec("emnist", (28, 28, 1), 47)
FMNIST_SPEC = VisionSpec("fmnist", (28, 28, 1), 10)
CIFAR10_SPEC = VisionSpec("cifar10", (32, 32, 3), 10)
CIFAR100_SPEC = VisionSpec("cifar100", (32, 32, 3), 100)

DATASETS = {
    "mnist": MNIST_SPEC,
    "emnist": EMNIST_SPEC,
    "fmnist": FMNIST_SPEC,
    "cifar10": CIFAR10_SPEC,
    "cifar100": CIFAR100_SPEC,
}

PAPER_MODELS = ("mlp", "mnistnet", "convnet", "resnet", "regnet")


def make_paper_model(name: str, spec: VisionSpec) -> VisionModel:
    if name == "mlp":
        return make_mlp(spec)
    if name in PAPER_MODELS:
        raise NotImplementedError(
            f"model {name!r} not ported yet, see ROADMAP.md")
    raise KeyError(name)
