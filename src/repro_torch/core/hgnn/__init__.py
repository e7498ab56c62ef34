"""HGNN models (RGCN / RGAT / Simple-HGN) with the FP -> NA -> SF stages,
on the banded NA executor."""
from repro_torch.core.hgnn.layers import (feature_projection,
                                          na_attention_banded, na_mean_banded,
                                          semantic_fusion,
                                          semantic_fusion_beta)
from repro_torch.core.hgnn.models import (HGNN, BandedBatch, HGNNConfig,
                                          init_params, params_from_numpy)

__all__ = [
    "BandedBatch",
    "HGNN",
    "HGNNConfig",
    "feature_projection",
    "init_params",
    "na_attention_banded",
    "na_mean_banded",
    "params_from_numpy",
    "semantic_fusion",
    "semantic_fusion_beta",
]
