"""The port's sharding: the partition rules (``partition``) and the
boundaries of the reference's ``shard_map`` as autograd Functions over
``torch.distributed`` (``collectives``)."""

from .partition import (MeshAxes, Partitioner, Shardings, Spec,
                        cache_slices, gather, permute_expert_params, shard,
                        shard_experts, shard_params)

__all__ = ["MeshAxes", "Partitioner", "Shardings", "Spec", "cache_slices",
           "gather", "permute_expert_params", "shard", "shard_experts",
           "shard_params"]
