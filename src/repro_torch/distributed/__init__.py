"""Sharded HGNN execution: shard plans over packed edge-block streams.

``build_shard_plan`` assigns every semantic graph's edge blocks to the
ranks of a mesh (relation- or edge-block-parallel) and
``ShardedHGNNExecutor`` runs the banded forward rank by rank in one
process.  Wire-up goes through ``repro_torch.api.ExecutorSpec(shard=...,
mesh_shape=...)``.

The LM partition specs live in ``repro_torch.train._lm_pspecs``, as in the
JAX package; importing their old names from here raises with a pointer.
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

_MOVED = ("param_pspecs", "data_pspec", "cache_pspecs", "shard_params")


def __getattr__(name):
    if name in _MOVED:
        raise ImportError(
            f"repro_torch.distributed.{name} lives in repro_torch.train._lm_pspecs: "
            "repro_torch.distributed holds only the sharded HGNN executor "
            "(ShardPlan / ShardedHGNNExecutor / build_shard_plan).")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
