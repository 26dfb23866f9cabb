"""repro_torch.checkpoint — durable checkpoints in the JAX package's
on-disk format, and full-FLState recovery points (``ckpt``)."""
from repro_torch.checkpoint.ckpt import (MANIFEST_VERSION, CheckpointError,
                                         CheckpointKeyError,
                                         CheckpointManager,
                                         CheckpointMissingError,
                                         CheckpointShapeError,
                                         CheckpointVersionError, load_arrays,
                                         load_checkpoint, load_fl_checkpoint,
                                         load_manifest, save_checkpoint,
                                         save_fl_checkpoint)

__all__ = [
    "MANIFEST_VERSION",
    "CheckpointError",
    "CheckpointKeyError",
    "CheckpointManager",
    "CheckpointMissingError",
    "CheckpointShapeError",
    "CheckpointVersionError",
    "load_arrays",
    "load_checkpoint",
    "load_fl_checkpoint",
    "load_manifest",
    "save_checkpoint",
    "save_fl_checkpoint",
]
