"""Dirichlet non-i.i.d. client partitioning (paper Fig. 5 protocol)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_per_client: int = 2,
) -> List[np.ndarray]:
    """Split sample indices over clients with Dir(alpha) label skew.

    Returns a list of index arrays, one per client. Lower alpha => more
    skewed (some clients see only a few labels), matching paper Fig. 5.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shards: List[List[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(num_clients))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            shards[i].extend(part.tolist())
    out = []
    for i, s in enumerate(shards):
        if len(s) < min_per_client:        # ensure every client can form a batch
            donor = int(np.argmax([len(t) for t in shards]))
            need = min_per_client - len(s)
            s = s + shards[donor][:need]
        arr = np.array(sorted(s), dtype=np.int64)
        out.append(arr)
    return out


def partition_stats(labels: np.ndarray, parts: List[np.ndarray]) -> Dict:
    """Per-client size + label histogram (for the Fig. 5-style printout)."""
    classes = np.unique(labels)
    hists = np.stack([
        np.bincount(labels[p], minlength=classes.max() + 1) for p in parts])
    return {"sizes": [len(p) for p in parts], "label_hist": hists}
