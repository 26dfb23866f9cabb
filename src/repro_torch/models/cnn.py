"""The paper's five small vision models.

* MLP        — 784-200-200-10 (199,210 params, matching the paper's count)
* MnistNet   — 2 conv + 2 linear (classic MNIST net)
* ConvNet    — 4 conv + 1 linear
* ResNet     — BN/dropout-free residual net (paper §5 deletes BN/dropout)
* RegNet     — BN-free simplified RegNet stem+stages

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
from repro_torch.models import layers
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


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=gen.device)


def _dense(p: Dict, h: torch.Tensor) -> torch.Tensor:
    return h @ p["w"] + p["b"]


def make_mlp(spec: VisionSpec, hidden: int = 200) -> VisionModel:
    d_in = int(np.prod(spec.input_shape))

    def init(gen):
        return {
            "l1": {"w": dense_init(gen, d_in, (d_in, hidden)),
                   "b": _zeros(gen, hidden)},
            "l2": {"w": dense_init(gen, hidden, (hidden, hidden)),
                   "b": _zeros(gen, hidden)},
            "l3": {"w": dense_init(gen, hidden, (hidden, spec.num_classes)),
                   "b": _zeros(gen, spec.num_classes)},
        }

    def apply(p, x):
        h = x.reshape(x.shape[0], -1)
        h = torch.relu(_dense(p["l1"], h))
        h = torch.relu(_dense(p["l2"], h))
        return _dense(p["l3"], h)

    return VisionModel(spec, init, apply)


# ---------------------------------------------------------------------------
# MnistNet — conv(10,5x5) conv(20,5x5) fc(50) fc(C)
# ---------------------------------------------------------------------------


def make_mnistnet(spec: VisionSpec) -> VisionModel:
    H, W, C = spec.input_shape

    def init(gen):
        flat = (H // 4) * (W // 4) * 20
        return {
            "c1": layers.conv2d_init(gen, C, 10, 5),
            "c2": layers.conv2d_init(gen, 10, 20, 5),
            "f1": {"w": dense_init(gen, flat, (flat, 50)),
                   "b": _zeros(gen, 50)},
            "f2": {"w": dense_init(gen, 50, (50, spec.num_classes)),
                   "b": _zeros(gen, spec.num_classes)},
        }

    def apply(p, x):
        h = layers.max_pool2x2(torch.relu(layers.conv2d(p["c1"], x)))
        h = layers.max_pool2x2(torch.relu(layers.conv2d(p["c2"], h)))
        # flatten in NHWC order, as the reference, so f1's rows pair with
        # the same features
        h = h.reshape(h.shape[0], -1)
        h = torch.relu(_dense(p["f1"], h))
        return _dense(p["f2"], h)

    return VisionModel(spec, init, apply)


# ---------------------------------------------------------------------------
# ConvNet — 4 conv + 1 linear
# ---------------------------------------------------------------------------


def make_convnet(spec: VisionSpec, widths=(32, 64, 128, 256)) -> VisionModel:
    C = spec.input_shape[2]

    def init(gen):
        p, cin = {}, C
        for i, w in enumerate(widths):
            p[f"c{i}"] = layers.conv2d_init(gen, cin, w, 3)
            cin = w
        p["fc"] = {"w": dense_init(gen, cin, (cin, spec.num_classes)),
                   "b": _zeros(gen, spec.num_classes)}
        return p

    def apply(p, x):
        h = x
        for i in range(len(widths)):
            h = torch.relu(layers.conv2d(p[f"c{i}"], h, stride=2 if i else 1))
        return _dense(p["fc"], torch.mean(h, dim=(1, 2)))

    return VisionModel(spec, init, apply)


# ---------------------------------------------------------------------------
# ResNet (BN-free) — basic blocks
# ---------------------------------------------------------------------------


def _shortcut(blk: Dict, h: torch.Tensor, stride: int) -> torch.Tensor:
    """A block's shortcut: the 1x1 projection where the width changes, else
    the identity, strided by slicing."""
    if "proj" in blk:
        return layers.conv2d(blk["proj"], h, stride=stride)
    if stride != 1:
        return h[:, ::stride, ::stride, :]
    return h


def make_resnet(spec: VisionSpec, widths=(16, 32, 64),
                blocks_per_stage: int = 1) -> VisionModel:
    C = spec.input_shape[2]

    def init(gen):
        p = {"stem": layers.conv2d_init(gen, C, widths[0], 3)}
        cin = widths[0]
        for s, w in enumerate(widths):
            for b in range(blocks_per_stage):
                blk = {
                    "c1": layers.conv2d_init(gen, cin if b == 0 else w, w, 3),
                    "c2": layers.conv2d_init(gen, w, w, 3),
                }
                if b == 0 and cin != w:
                    blk["proj"] = layers.conv2d_init(gen, cin, w, 1)
                p[f"s{s}b{b}"] = blk
            cin = w
        p["fc"] = {"w": dense_init(gen, cin, (cin, spec.num_classes)),
                   "b": _zeros(gen, spec.num_classes)}
        return p

    def apply(p, x):
        h = torch.relu(layers.conv2d(p["stem"], x))
        for s in range(len(widths)):
            for b in range(blocks_per_stage):
                blk = p[f"s{s}b{b}"]
                stride = 2 if (s > 0 and b == 0) else 1
                r = torch.relu(layers.conv2d(blk["c1"], h, stride=stride))
                r = layers.conv2d(blk["c2"], r)
                h = torch.relu(r + _shortcut(blk, h, stride))
        return _dense(p["fc"], torch.mean(h, dim=(1, 2)))

    return VisionModel(spec, init, apply)


# ---------------------------------------------------------------------------
# RegNet (BN-free, simplified X-block: 1x1 -> 3x3 -> 1x1)
# ---------------------------------------------------------------------------


def make_regnet(spec: VisionSpec, widths=(24, 56, 152),
                depths=(1, 1, 2)) -> VisionModel:
    C = spec.input_shape[2]

    def init(gen):
        p = {"stem": layers.conv2d_init(gen, C, widths[0], 3)}
        cin = widths[0]
        for s, (w, dep) in enumerate(zip(widths, depths)):
            for b in range(dep):
                blk = {
                    "c1": layers.conv2d_init(gen, cin if b == 0 else w, w, 1),
                    "c3": layers.conv2d_init(gen, w, w, 3),
                    "c2": layers.conv2d_init(gen, w, w, 1),
                }
                if b == 0 and cin != w:
                    blk["proj"] = layers.conv2d_init(gen, cin, w, 1)
                p[f"s{s}b{b}"] = blk
            cin = w
        p["fc"] = {"w": dense_init(gen, cin, (cin, spec.num_classes)),
                   "b": _zeros(gen, spec.num_classes)}
        return p

    def apply(p, x):
        h = torch.relu(layers.conv2d(p["stem"], x))
        for s, dep in enumerate(depths):
            for b in range(dep):
                blk = p[f"s{s}b{b}"]
                stride = 2 if (s > 0 and b == 0) else 1
                r = torch.relu(layers.conv2d(blk["c1"], h))
                r = torch.relu(layers.conv2d(blk["c3"], r, stride=stride))
                r = layers.conv2d(blk["c2"], r)
                h = torch.relu(r + _shortcut(blk, h, stride))
        return _dense(p["fc"], torch.mean(h, dim=(1, 2)))

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

PAPER_MODELS = {
    "mlp": make_mlp,
    "mnistnet": make_mnistnet,
    "convnet": make_convnet,
    "resnet": make_resnet,
    "regnet": make_regnet,
}


def make_paper_model(name: str, spec: VisionSpec) -> VisionModel:
    return PAPER_MODELS[name](spec)
