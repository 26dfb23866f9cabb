"""``build_model(cfg)`` + synthetic-feature spec helpers."""
from __future__ import annotations

from repro_torch.configs.base import CompressorConfig, ModelConfig
from repro_torch.core.threesfc import SynSpec
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig) -> LM:
    """The LM facade for ``cfg``; enc-dec configs are not ported yet."""
    if cfg.enc_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec model is not ported yet, see "
            f"ROADMAP.md")
    return LM(cfg)


def vision_syn_spec(spec, comp: CompressorConfig) -> SynSpec:
    """Classifier payload: raw synthetic pixels + soft labels (paper's form)."""
    return SynSpec(
        x_shape=(comp.syn_batch, *spec.input_shape),
        num_classes=spec.num_classes,
        label_rank=0,
        label_lead=(comp.syn_batch,),
    )
