"""Frontend pipeline of the port: SGB -> Restructure -> packing as one
cached engine (host numpy)."""
from repro_torch.pipeline.cache import CacheStats, SemanticGraphCache
from repro_torch.pipeline.frontend import (FrontendPipeline, FrontendResult,
                                           PipelineConfig)

__all__ = [
    "CacheStats",
    "FrontendPipeline",
    "FrontendResult",
    "PipelineConfig",
    "SemanticGraphCache",
]
