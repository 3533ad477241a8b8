"""The port's checkpointing: async save, keep-K, restore onto a
device."""

from .ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
