"""Heterogeneous-graph substrate of the port: typed graphs, relations, graph
deltas, datasets.

Host-side numpy, a copy of the JAX package's ``repro.hetero`` so that the
port never imports that package.
"""
from repro_torch.hetero.datasets import DATASETS, make_dataset
from repro_torch.hetero.delta import GraphDelta, apply_delta, union_relations
from repro_torch.hetero.graph import (CompositionCost, HetGraph, Relation,
                                      compose_relations)

__all__ = [
    "CompositionCost",
    "DATASETS",
    "GraphDelta",
    "HetGraph",
    "Relation",
    "apply_delta",
    "compose_relations",
    "make_dataset",
    "union_relations",
]
