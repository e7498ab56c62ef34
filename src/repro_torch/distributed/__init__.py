"""Sharded HGNN execution: shard plans over packed edge-block streams.

``build_shard_plan`` assigns every semantic graph's edge blocks to the
ranks of a mesh (relation- or edge-block-parallel) and
``ShardedHGNNExecutor`` runs the banded forward rank by rank in one
process.  Wire-up goes through ``repro_torch.api.ExecutorSpec(shard=...,
mesh_shape=...)``.
"""
from repro_torch.distributed.hgnn import (SHARD_MODES, ShardedHGNNExecutor,
                                          ShardPlan, ShardSlice,
                                          build_shard_plan)

__all__ = [
    "SHARD_MODES",
    "ShardPlan",
    "ShardSlice",
    "ShardedHGNNExecutor",
    "build_shard_plan",
]
