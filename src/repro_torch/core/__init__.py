"""repro_torch.core — the paper's contribution: 3SFC, EF and the baseline
compressors.

Method dispatch lives in ``repro_torch.core.strategy``: one registered
``CompressionStrategy`` per compression method (``make_strategy``,
``register_strategy``); ``compressor`` keeps the historical
``make_compressor`` facade over it.
"""
from repro_torch.core.strategy import (CompressionStrategy, make_strategy,
                                       register_strategy, strategy_kinds)

__all__ = ["CompressionStrategy", "make_strategy", "register_strategy",
           "strategy_kinds"]
