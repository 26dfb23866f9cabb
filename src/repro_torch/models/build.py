"""``build_model(cfg)`` + synthetic-feature spec helpers.

``build_model`` returns the ``LM`` facade, which exposes ``init``,
``loss(params, batch)`` and the 3SFC-compatible ``syn_loss(params,
syn)``; ``syn_spec_for`` gives the shapes of an LM's 3SFC payload and
``syn_loss_fn`` the compressor's uniform ``loss_fn(params, syn)``. The
enc-dec model is not ported yet.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import CompressorConfig, ModelConfig
from repro_torch.core.threesfc import SynSpec
from repro_torch.models.transformer import LM


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.enc_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec model is not ported yet, see "
            f"ROADMAP.md")


def build_model(cfg: ModelConfig) -> LM:
    """The LM facade for ``cfg``; enc-dec configs are not ported yet."""
    _check_decoder_only(cfg)
    return LM(cfg)


def syn_spec_for(cfg: ModelConfig, comp: CompressorConfig) -> SynSpec:
    """Shapes of the 3SFC payload for this architecture: ``syn_batch``
    sequences of ``syn_seq`` soft input embeddings and their soft labels
    over the vocabulary (dense, or of rank ``soft_label_rank``)."""
    _check_decoder_only(cfg)
    n, L = comp.syn_batch, comp.syn_seq
    return SynSpec(
        x_shape=(n, L, cfg.d_model),
        num_classes=cfg.vocab_size,
        label_rank=comp.soft_label_rank,
        label_lead=(n, L),
    )


def syn_loss_fn(model: LM) -> Callable:
    """Uniform ``loss_fn(params, syn)`` for the compressor."""
    return model.syn_loss


def vision_syn_spec(spec, comp: CompressorConfig) -> SynSpec:
    """Classifier payload: raw synthetic pixels + soft labels (paper's form)."""
    return SynSpec(
        x_shape=(comp.syn_batch, *spec.input_shape),
        num_classes=spec.num_classes,
        label_rank=0,
        label_lead=(comp.syn_batch,),
    )
