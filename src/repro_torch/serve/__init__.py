"""Serving substrate: the LM KV-cache engine (continuous batching over a
fixed slot batch) and the async multi-tenant HGNN engine over compiled
``repro_torch.api`` sessions, plus the serving-tier failure taxonomy and
fault injector."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import (FaultInjector, PermanentFault,
                                      TransientFault, is_transient)
from repro_torch.serve.hgnn import (AdmissionError, CircuitOpen,
                                    DeadlineExceeded, HGNNRequest,
                                    HGNNResponse, HGNNServeEngine,
                                    QuotaExceeded, TenantHandle)

__all__ = [
    "ServeEngine",
    "Request",
    "AdmissionError",
    "QuotaExceeded",
    "DeadlineExceeded",
    "CircuitOpen",
    "HGNNRequest",
    "HGNNResponse",
    "HGNNServeEngine",
    "TenantHandle",
    "FaultInjector",
    "TransientFault",
    "PermanentFault",
    "is_transient",
]
