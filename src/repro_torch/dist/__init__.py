"""Distributed-execution layer: mesh-rule sharding for params, optimizer
state, KV/SSM caches and batches, and the collectives of the meshed paths
over ``torch.distributed`` (:mod:`.sharding`)."""

from .sharding import (MeshRules, P, ShapeMesh, axis_size, batch_spec,
                       cache_specs, constrain, constrain_layer_params,
                       logical_to_spec, param_specs, shard_map_compat, zero1_specs)

__all__ = [
    "MeshRules", "P", "ShapeMesh", "axis_size", "batch_spec", "cache_specs",
    "constrain", "constrain_layer_params", "logical_to_spec", "param_specs",
    "shard_map_compat", "zero1_specs",
]
