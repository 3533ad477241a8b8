"""The port's model stack for the dense, SSM and hybrid families: layers,
blocks, the SSD scan's plain forms, the assembled model and the weight
converter from the JAX package's tree."""

from .convert import params_from_reference
from .model import (Attention, Layer, LoRA, MLP, MambaLayer, Model,
                    ShardCtx, SharedBlock, block_plan, forward, init_cache,
                    init_params)

__all__ = ["Attention", "Layer", "LoRA", "MLP", "MambaLayer", "Model",
           "ShardCtx", "SharedBlock", "block_plan", "forward", "init_cache",
           "init_params", "params_from_reference"]
