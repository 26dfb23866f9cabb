"""Payload-budget accounting and matched-compressor construction.

Budget math (paper Table 2 / Eq. 1): for the MLP (199,210 params) the 3SFC
payload is 28·28·1 + 10 + 1 = 795 floats -> compression ratio 250.6x.
Competitor knobs derive from the same budget B: DGC keeps k = B/2 entries
(value + index per entry), STC/signSGD sit at their 32x quantization limit.

``measured_wire_bytes`` reports the same budgets as serialized sizes: the
``repro_torch.comm`` codec's framed uint8 buffer.
"""
from __future__ import annotations

from typing import Dict, Optional

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
    """The paper's five methods at the paper's budget relations; every kind
    is checked against the strategy registry so the table cannot drift from
    what the runtime can dispatch."""
    from repro_torch.core.strategy import strategy_kinds

    B = payload_budget(model_name, spec, syn_batch)
    topk_ratio = max(B / 2.0, 1.0) / d          # 2k floats = B
    stc_ratio = (d / 33.0) / d                  # k + k/32 + 1 ~= d/32
    table = {
        "fedavg": CompressorConfig(kind="identity", error_feedback=False),
        "dgc": CompressorConfig(kind="topk", keep_ratio=topk_ratio),
        "signsgd": CompressorConfig(kind="signsgd"),
        "stc": CompressorConfig(kind="stc", keep_ratio=stc_ratio),
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


def measured_wire_bytes(cfg: CompressorConfig, params, *,
                        syn_spec=None) -> Optional[float]:
    """Serialized uplink frame size (header included) for one client-round,
    or None for kinds without a registered wire codec."""
    from repro_torch.comm.codec import wire_bytes  # lazy: comm imports core

    try:
        return float(wire_bytes(cfg, params, syn_spec=syn_spec))
    except KeyError:
        return None
