"""The port's optimizer: AdamW with float32 moments, global-norm
clipping, a warmup + cosine schedule and optional int8 gradient
compression with error feedback."""

from .adamw import (OptConfig, apply_updates, global_norm, init_opt_state,
                    schedule)

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule"]
