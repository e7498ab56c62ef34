"""Serving substrate: the LM KV-cache engine (continuous batching over a
fixed slot batch)."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
