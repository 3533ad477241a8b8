"""The port's model stack for the dense, MoE, SSM and hybrid families:
layers, blocks, the MoE FFN, the SSD scan's plain forms, the assembled
model and the weight converter from the JAX package's tree."""

from .convert import params_from_reference
from .model import (MLP, Attention, Layer, LoRA, MambaLayer, Model, MoE,
                    ShardCtx, SharedBlock, block_plan, forward, init_cache,
                    init_params)

__all__ = ["Attention", "Layer", "LoRA", "MLP", "MambaLayer", "Model",
           "MoE", "ShardCtx", "SharedBlock", "block_plan", "forward",
           "init_cache", "init_params", "params_from_reference"]
