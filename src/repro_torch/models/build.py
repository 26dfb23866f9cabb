"""Synthetic-feature spec helpers."""
from __future__ import annotations

from repro_torch.configs.base import CompressorConfig
from repro_torch.core.threesfc import SynSpec


def vision_syn_spec(spec, comp: CompressorConfig) -> SynSpec:
    """Classifier payload: raw synthetic pixels + soft labels (paper's form)."""
    return SynSpec(
        x_shape=(comp.syn_batch, *spec.input_shape),
        num_classes=spec.num_classes,
        label_rank=0,
        label_lead=(comp.syn_batch,),
    )
