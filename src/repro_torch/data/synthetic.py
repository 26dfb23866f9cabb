"""Synthetic datasets: class-conditional images (the paper's dataset
shapes) and token sequences with a planted bigram map (the LM runs).

Each class c gets a fixed random template T_c; samples are
``clip(T_c / 2 + 1/2 + sigma * noise, 0, 1)``. Token sequences follow a
random permutation of the vocabulary, each step replaced by a uniform
token with probability ``noise``. Both tasks are learnable, so
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


def make_token_dataset(
    gen: torch.Generator,
    num_seqs: int,
    seq_len: int,
    vocab: int,
    noise: float = 0.1,
) -> np.ndarray:
    """(num_seqs, seq_len) int32 with a planted random bigram map: the
    first token uniform, each next one ``bigram[tok]`` or, with
    probability ``noise``, a uniform token. Every draw comes from ``gen``,
    on its device."""
    dev = gen.device
    bigram = torch.randperm(vocab, generator=gen, device=dev)
    tok = torch.randint(0, vocab, (num_seqs,), generator=gen, device=dev)
    seqs = [tok]
    for _ in range(seq_len - 1):
        rnd = torch.randint(0, vocab, tok.shape, generator=gen, device=dev)
        use_rnd = torch.rand(tok.shape, generator=gen, device=dev) < noise
        tok = torch.where(use_rnd, rnd, bigram[tok])
        seqs.append(tok)
    return torch.stack(seqs, dim=1).cpu().numpy().astype(np.int32)
