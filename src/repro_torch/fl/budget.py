"""Payload-budget accounting and matched-compressor construction.

Budget math (paper Table 2 / Eq. 1): for the MLP (199,210 params) the 3SFC
payload is 28·28·1 + 10 + 1 = 795 floats -> compression ratio 250.6x.
This slice registers two strategies, so the table holds the methods they
run: ``fedavg`` (identity) and ``threesfc``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import CompressorConfig
from repro_torch.models.cnn import VisionSpec


def payload_budget(model_name: str, spec: VisionSpec, syn_batch: int = 1
                   ) -> float:
    """3SFC budget B for this (model, dataset): syn pixels + soft labels + s."""
    return float(syn_batch * (int(np.prod(spec.input_shape))
                              + spec.num_classes) + 1)


def matched_compressors(model_name: str, spec: VisionSpec, d: int,
                        syn_batch: int = 1) -> Dict[str, CompressorConfig]:
    """The ported methods at the paper's settings; every kind is checked
    against the strategy registry so the table cannot drift from what the
    runtime can dispatch."""
    from repro_torch.core.strategy import strategy_kinds

    table = {
        "fedavg": CompressorConfig(kind="identity", error_feedback=False),
        # S=10 encoder iterations (Algorithm 1 line 7; "single-step" refers
        # to the single SIMULATION step, vs FedSynth's K-step unroll)
        "threesfc": CompressorConfig(kind="threesfc", syn_batch=syn_batch,
                                     syn_steps=10, syn_lr=0.1),
    }
    unknown = sorted({c.kind for c in table.values()} - set(strategy_kinds()))
    if unknown:
        raise ValueError(f"budget table names unregistered strategy kinds "
                         f"{unknown} (registered: {strategy_kinds()})")
    return table
