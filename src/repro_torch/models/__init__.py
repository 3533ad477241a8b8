"""The port's model stack for the dense family: layers, blocks, the
assembled model and the weight converter from the JAX package's tree."""

from .convert import params_from_reference
from .model import (Attention, Layer, MLP, Model, ShardCtx, forward,
                    init_cache, init_params)

__all__ = ["Attention", "Layer", "MLP", "Model", "ShardCtx", "forward",
           "init_cache", "init_params", "params_from_reference"]
