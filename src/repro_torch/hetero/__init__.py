"""Heterogeneous-graph substrate of the port: typed graphs, relations, datasets.

Host-side numpy, a copy of the JAX package's ``repro.hetero`` (without the
graph-delta path) so that the port never imports that package.
"""
from repro_torch.hetero.datasets import DATASETS, make_dataset
from repro_torch.hetero.graph import (CompositionCost, HetGraph, Relation,
                                      compose_relations)

__all__ = [
    "CompositionCost",
    "DATASETS",
    "HetGraph",
    "Relation",
    "compose_relations",
    "make_dataset",
]
