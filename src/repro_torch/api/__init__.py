"""repro_torch.api — the port's execution surface.

One ``ExecutorSpec`` declares how to run (planner, NA executor, device,
layout policy); one ``Session`` owns the cached frontend engine;
``session.compile(graph, targets, HGNNConfig)`` returns a ``CompiledHGNN``
whose ``init`` and ``forward`` take no backend arguments; ``ServePolicy``
declares how the serving engine admits and batches.
"""
from repro_torch.api.session import (CompiledHGNN, Session, SessionStats,
                                     canonical_node_ids, device_features)
from repro_torch.api.spec import ExecutorSpec, ServePolicy

__all__ = [
    "CompiledHGNN",
    "ExecutorSpec",
    "ServePolicy",
    "Session",
    "SessionStats",
    "canonical_node_ids",
    "device_features",
]
