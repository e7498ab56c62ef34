"""HGNN models (RGCN / RGAT / Simple-HGN) with the FP -> NA -> SF stages,
on the banded NA executor or the segment-sum executor."""
from repro_torch.core.hgnn.layers import (edge_softmax_weights,
                                          feature_projection, na_attention,
                                          na_attention_banded, na_mean,
                                          na_mean_banded, semantic_fusion,
                                          semantic_fusion_beta)
from repro_torch.core.hgnn.models import (HGNN, BandedBatch, HGNNConfig,
                                          SemanticGraphBatch,
                                          banded_graphs_from_pipeline,
                                          graphs_from_pipeline, graphs_from_sgb,
                                          init_params,
                                          package_batches, params_from_numpy)

__all__ = [
    "BandedBatch",
    "HGNN",
    "HGNNConfig",
    "SemanticGraphBatch",
    "banded_graphs_from_pipeline",
    "edge_softmax_weights",
    "feature_projection",
    "graphs_from_pipeline",
    "graphs_from_sgb",
    "init_params",
    "na_attention",
    "na_attention_banded",
    "na_mean",
    "na_mean_banded",
    "package_batches",
    "params_from_numpy",
    "semantic_fusion",
    "semantic_fusion_beta",
]
