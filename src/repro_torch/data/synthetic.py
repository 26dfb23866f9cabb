"""Synthetic class-conditional image data (the paper's dataset shapes).

Each class c gets a fixed random template T_c; samples are
``clip(T_c / 2 + 1/2 + sigma * noise, 0, 1)``. The task is learnable, so
convergence orderings between compressors are measurable.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class ClassImageDataset(NamedTuple):
    x: np.ndarray          # (N, H, W, C) float32 in [0, 1]
    y: np.ndarray          # (N,) int32
    num_classes: int


def make_class_image_dataset(
    gen: torch.Generator,
    num_samples: int,
    input_shape: Tuple[int, int, int],
    num_classes: int,
    sigma: float = 0.35,
    template_scale: float = 1.0,
    template_seed: int = 7,
) -> ClassImageDataset:
    """Labels and noise come from ``gen``; templates come from
    ``template_seed`` (not ``gen``), so train and test splits drawn from
    different generators share the same class structure."""
    dev = gen.device
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(template_seed)
    templates = template_scale * torch.randn((num_classes, *input_shape),
                                             generator=tgen, device=dev)
    y = torch.randint(0, num_classes, (num_samples,), generator=gen,
                      device=dev)
    noise = sigma * torch.randn((num_samples, *input_shape), generator=gen,
                                device=dev)
    x = torch.clamp(templates[y] * 0.5 + 0.5 + noise, 0.0, 1.0)
    return ClassImageDataset(x.cpu().numpy().astype(np.float32),
                             y.cpu().numpy().astype(np.int32), num_classes)
