"""Frontend pipeline of the port: SGB -> Restructure -> packing as one
cached engine (host numpy), with an incremental path for graph deltas."""
from repro_torch.pipeline.cache import (CacheStats, SemanticGraphCache,
                                        default_cache)
from repro_torch.pipeline.frontend import (DeltaResult, FrontendPipeline,
                                           FrontendResult, PipelineConfig)

__all__ = [
    "CacheStats",
    "DeltaResult",
    "FrontendPipeline",
    "FrontendResult",
    "PipelineConfig",
    "SemanticGraphCache",
    "default_cache",
]
