from .archs import ARCHS, SKIPS, cells
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ModelConfig, ShapeConfig, reduced)

__all__ = ["ARCHS", "SKIPS", "cells", "ModelConfig", "ShapeConfig",
           "reduced", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K"]
