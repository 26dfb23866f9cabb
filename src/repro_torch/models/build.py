"""``build_model(cfg)`` + synthetic-feature spec helpers.

``build_model`` returns the ``LM`` or ``EncDec`` facade; both expose
``init``, ``loss(params, batch)`` and a 3SFC-compatible ``syn_loss``.
``syn_spec_for`` gives the shapes of a model's 3SFC payload and
``syn_loss_fn`` the compressor's uniform ``loss_fn(params, syn)`` (for an
``EncDec`` with the encoder length bound here).
"""
from __future__ import annotations

import functools
from typing import Callable, Union

from repro_torch.configs.base import CompressorConfig, ModelConfig
from repro_torch.core.threesfc import SynSpec
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

# encoder-side synthetic frames for enc-dec syn payloads
ENC_SYN_LEN = 8


def build_model(cfg: ModelConfig) -> Union[LM, EncDec]:
    if cfg.enc_layers > 0:
        return EncDec(cfg)
    return LM(cfg)


def syn_spec_for(cfg: ModelConfig, comp: CompressorConfig) -> SynSpec:
    """Shapes of the 3SFC payload for this architecture: ``syn_batch``
    sequences of ``syn_seq`` soft input embeddings (behind ENC_SYN_LEN
    encoder frames for an enc-dec model) and their soft labels over the
    vocabulary (dense, or of rank ``soft_label_rank``)."""
    n, L = comp.syn_batch, comp.syn_seq
    lead = ENC_SYN_LEN if cfg.enc_layers > 0 else 0
    return SynSpec(
        x_shape=(n, lead + L, cfg.d_model),
        num_classes=cfg.vocab_size,
        label_rank=comp.soft_label_rank,
        label_lead=(n, L),
    )


def syn_loss_fn(model) -> Callable:
    """Uniform ``loss_fn(params, syn)`` for the compressor."""
    if isinstance(model, EncDec):
        return functools.partial(model.syn_loss, enc_len=ENC_SYN_LEN)
    return model.syn_loss


def vision_syn_spec(spec, comp: CompressorConfig) -> SynSpec:
    """Classifier payload: raw synthetic pixels + soft labels (paper's form)."""
    return SynSpec(
        x_shape=(comp.syn_batch, *spec.input_shape),
        num_classes=spec.num_classes,
        label_rank=0,
        label_lead=(comp.syn_batch,),
    )
