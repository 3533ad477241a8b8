"""The port's checkpointing: async save, keep-K, restore onto a
device; and a checkpoint of the JAX package's training run read into the
port's train state."""

from .ckpt import CheckpointManager
from .convert import ReferenceCheckpointError, state_from_reference

__all__ = ["CheckpointManager", "ReferenceCheckpointError",
           "state_from_reference"]
