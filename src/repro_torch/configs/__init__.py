"""repro_torch.configs — model, FL, compressor and run configuration.

``base`` holds the dataclasses and the architecture registry (one module
per ``ARCH_IDS`` entry); ``run`` holds ``RunConfig``, the round's
execution knobs.
"""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      CompressorConfig, FLConfig,
                                      ModelConfig, ShapeConfig, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.configs.run import RunConfig

__all__ = ["ARCH_IDS", "CompressorConfig", "FLConfig", "INPUT_SHAPES",
           "ModelConfig", "RunConfig", "ShapeConfig", "get_config",
           "get_smoke_config", "list_archs"]
