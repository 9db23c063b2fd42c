"""Tree checkpoints of the port (``torch.save`` leaves beside a JSON index)."""
from repro_torch.checkpoint.io import (
    CheckpointCorruptError,
    checkpoint_metadata,
    load_pytree,
    restore_checkpoint,
    save_checkpoint,
    save_pytree,
)

__all__ = [
    "CheckpointCorruptError",
    "checkpoint_metadata",
    "load_pytree",
    "restore_checkpoint",
    "save_checkpoint",
    "save_pytree",
]
