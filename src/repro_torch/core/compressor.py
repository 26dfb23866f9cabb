"""Back-compat facade over the ``repro_torch.core.strategy`` registry.

The port of the JAX package's ``core/compressor.py``. Every compression
method is one registered ``CompressionStrategy``; this module keeps the two
seed-era entry points for existing callers:

* ``TreeCompressor`` — a thin delegator exposing the strategy's derived
  steps under the historical names (``step``, ``wire_step``,
  ``compress_tree``, ``payload_floats``, ``init_state``). EF residuals are
  trees mirroring the parameters, compressed per leaf.
* ``make_compressor(cfg, ...)`` — deprecated shim (it warns once per
  process): builds the registered strategy and wraps it. New code calls
  ``make_strategy`` and hands the strategy to ``fl.round.build_fl_round``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import CompressorConfig
from repro_torch.core import threesfc
from repro_torch.core.strategy import (CompressMetrics, CompressionStrategy,
                                       TreeCompressed, leaf_k, make_strategy,
                                       warn_deprecated_once)
from repro_torch.core.tree import PyTree

__all__ = ["CompressMetrics", "TreeCompressed", "TreeCompressor",
           "leaf_k", "make_compressor"]


class TreeCompressor:
    """Historical facade: the strategy's derived steps under the old names."""

    def __init__(self, strategy: CompressionStrategy):
        self.strategy = strategy
        self.cfg = strategy.cfg
        # (key, u_tree, params) -> TreeCompressed, for callers that need the
        # raw payload
        self.compress_tree = strategy.client_encode

    def init_state(self, params: PyTree) -> PyTree:
        """EF residual tree (zeros, f32) mirroring params."""
        return self.strategy.init_ef_state(params)

    def payload_floats(self, params: PyTree) -> float:
        return self.strategy.payload_floats(params)

    def step(self, key, g_tree, e_tree, params):
        """Returns (recon_tree, new_e_tree, CompressMetrics)."""
        return self.strategy.step(key, g_tree, e_tree, params)

    def wire_step(self, key, g_tree, e_tree, params, *, codec,
                  round_idx=0, client_idx=0):
        """Codec-mode step: (encoded uint8 buffer, new_e_tree, metrics)."""
        return self.strategy.wire_step(key, g_tree, e_tree, params,
                                       codec=codec, round_idx=round_idx,
                                       client_idx=client_idx)


def make_compressor(
    cfg: CompressorConfig,
    *,
    loss_fn: Optional[threesfc.LossFn] = None,
    syn_spec: Optional[threesfc.SynSpec] = None,
    local_lr: float = 0.01,
) -> TreeCompressor:
    """Deprecated: ``make_strategy`` + ``TreeCompressor`` in one call."""
    warn_deprecated_once(
        "make_compressor",
        "repro_torch.core.strategy.make_strategy(cfg, ...)")
    return TreeCompressor(make_strategy(cfg, loss_fn=loss_fn,
                                        syn_spec=syn_spec,
                                        local_lr=local_lr))
