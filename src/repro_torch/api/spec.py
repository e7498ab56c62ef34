"""ExecutorSpec: the one declaration of *how* HGNN work executes in the port.

The JAX package's spec names a ``kernel_backend`` (``interpret`` |
``pallas``) that has no meaning in PyTorch.  Here ``device`` takes its
place: on ``"cuda"`` the banded NA path (and the device SGB composer)
launches the hand-written CUDA kernels, on ``"cpu"`` it runs their plain
versions.  ``na_executor="jnp"`` keeps the reference's name for the
segment-sum executor (plain PyTorch scatters over global edge lists).
The other validation invariants stay: ``banded`` implies packing and
requires ``restructure``, and unknown values raise ``ValueError``.
``shard`` (``"relation"`` or ``"edge_block"``, with the banded executor)
runs the forward over a shard plan on a mesh of ranks
(``repro_torch.distributed``); ``mesh_shape`` fixes the rank count.

``ServePolicy`` is the serving sibling (how ``HGNNServeEngine`` admits and
batches requests): the reference's knobs, defaults and validation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.pipeline.frontend import PipelineConfig

_PLANNERS = ("naive", "ctt", "ctt_cache", "ctt_dp")
_SGB_BACKENDS = ("host", "device")
_NA_EXECUTORS = ("jnp", "banded")
_DEVICE_TYPES = ("cuda", "cpu")
_SHARD_MODES = ("none", "relation", "edge_block")


@dataclasses.dataclass(frozen=True)
class ExecutorSpec:
    """How to plan, build and execute — everything but the workload.

    ``device`` is where the model runs (``"cuda"``, ``"cuda:N"`` or
    ``"cpu"``), and with ``sgb_backend="device"`` also where the semantic
    graphs are composed; ``pack=None`` resolves to what ``na_executor``
    needs.  ``shard`` spreads the banded NA over the ranks of
    ``launch.mesh.device_pool(device)``: ``"relation"`` keeps each
    semantic graph's block stream whole, ``"edge_block"`` also splits
    oversized relations along dst-tile boundaries.  ``mesh_shape``
    optionally fixes the rank count (e.g. ``(4,)``).

    Example::

        ExecutorSpec(na_executor="banded", device="cpu").pack  # True
        ExecutorSpec(shard="edge_block", mesh_shape=(4,))
    """

    planner: str = "ctt"
    sgb_backend: str = "host"
    na_executor: str = "banded"
    device: str = "cuda"
    restructure: bool = True
    degree_order: bool = True
    affinity: str = "barycenter"
    pack: Optional[bool] = None
    shard: str = "none"
    mesh_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        """Validate every field (unknown values raise ``ValueError``)."""
        for field, value, legal in (
            ("planner", self.planner, _PLANNERS),
            ("sgb_backend", self.sgb_backend, _SGB_BACKENDS),
            ("na_executor", self.na_executor, _NA_EXECUTORS),
            ("shard", self.shard, _SHARD_MODES),
        ):
            if value not in legal:
                raise ValueError(f"ExecutorSpec.{field}={value!r} not in {legal}")
        try:
            dev_type = torch.device(self.device).type
        except (RuntimeError, TypeError) as err:
            raise ValueError(f"ExecutorSpec.device={self.device!r}: {err}") from None
        if dev_type not in _DEVICE_TYPES:
            raise ValueError(
                f"ExecutorSpec.device={self.device!r} not on {_DEVICE_TYPES}")
        if self.na_executor == "banded":
            if self.pack is False:
                raise ValueError(
                    "na_executor='banded' implies packing: the banded NA "
                    "kernels consume PackedEdges blocks")
            if not self.restructure:
                raise ValueError(
                    "na_executor='banded' requires restructure=True (the "
                    "banded layout is the restructurer's schedule)")
        if self.pack and not self.restructure:
            raise ValueError(
                "pack=True requires restructure=True (PackedEdges blocks "
                "are built from the restructured schedule)")
        if self.shard != "none" and self.na_executor != "banded":
            raise ValueError(
                f"shard={self.shard!r} requires na_executor='banded': the "
                "shard plan assigns the restructurer's packed edge-block "
                "streams to devices (the jnp path has none)")
        if self.mesh_shape is not None:
            if self.shard == "none":
                raise ValueError(
                    "mesh_shape without sharding: set shard='relation' or "
                    "'edge_block' (or drop mesh_shape)")
            shape = tuple(int(s) for s in self.mesh_shape)
            if not shape or any(s < 1 for s in shape):
                raise ValueError(
                    f"mesh_shape must be a non-empty tuple of positive "
                    f"ints, got {self.mesh_shape!r}")
            object.__setattr__(self, "mesh_shape", shape)
        if self.pack is None:
            object.__setattr__(self, "pack", self.na_executor == "banded")

    def pipeline_config(self) -> PipelineConfig:
        """Lower the spec onto the frontend engine's config."""
        return PipelineConfig(
            planner=self.planner,
            backend=self.sgb_backend,
            device=self.device,
            restructure=self.restructure,
            degree_order=self.degree_order,
            affinity=self.affinity,
            renumbered=True,
            pack=bool(self.pack),
        )


_BACKPRESSURE = ("block", "reject")
_SUBSET_MODES = ("head", "dependency")


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """How ``repro_torch.serve.HGNNServeEngine`` admits and batches requests —
    the serving sibling of :class:`ExecutorSpec` (*how to serve*, while
    the spec says *how to execute*).

    ``subset_threshold`` — when every queued request for a registration
    names explicit node ids and their union covers at most this fraction
    of the target vertices, the engine serves the group through one
    compiled *subset forward* instead of the full-graph forward.  ``0.0``
    disables subset serving; ``1.0`` always takes it when every request
    is explicit.

    ``subset_mode`` — which subset forward serves such a group:
    ``"head"`` (``CompiledHGNN.forward_subset``: full message passing,
    head + host transfer only over the union) or ``"dependency"``
    (``forward_subset(mode="dependency")``: message passing itself runs
    over the union's k-hop dependency closure, so compute and peak live
    arrays are bounded by the receptive field, not the graph).

    ``dependency_threshold`` — the frontier-coverage fallback for
    ``subset_mode="dependency"``: when the union's k-hop closure covers
    more than this fraction of the graph's vertices (dense graphs blow
    the closure up to nearly everything within a hop or two), the sliced
    execution would pay full-graph compute plus slicing overhead, so the
    group falls back to the plain full forward instead.

    ``bucket_min`` — smallest padded id-buffer bucket for the subset
    forward (buckets are powers of two, so resubmissions retrace only
    when the union outgrows the largest bucket seen).

    ``max_queue`` / ``backpressure`` — the admission queue bound and what
    ``submit`` does when it is full: ``"block"`` waits for the serving
    loop to drain capacity, ``"reject"`` raises ``AdmissionError``
    immediately (shed load at the edge).

    ``deadline_ms`` — the default per-request latency SLO: a request
    whose deadline expires before its group enters a compiled forward
    fails fast with ``DeadlineExceeded`` instead of riding (and
    slowing) a batch whose result nobody will use.  ``None`` disables
    deadlines; ``HGNNRequest.deadline_ms`` overrides per request.

    ``tenant_rate`` / ``tenant_burst`` — per-registration token-bucket
    admission: each tenant refills at ``tenant_rate`` requests/second up
    to ``tenant_burst`` tokens (default ``max(1, ceil(rate))``), and a
    submit without tokens raises ``QuotaExceeded`` — a hot tenant sheds
    its *own* load instead of filling the shared queue.  ``None``
    disables quotas.

    ``max_retries`` / ``retry_backoff_ms`` / ``retry_backoff_cap_ms`` —
    the recovery ladder's retry rung: a serve-group failure classified
    *transient* (``repro_torch.serve.faults.is_transient``) is retried up to
    ``max_retries`` times with capped exponential backoff
    (``min(cap, base * 2**attempt)``); permanent failures fail the
    group's futures immediately.

    ``breaker_threshold`` / ``breaker_cooldown_ms`` — the per-
    registration circuit breaker: ``breaker_threshold`` *consecutive*
    serve failures open the breaker (requests fail fast with
    ``CircuitOpen``, no forward attempted); after
    ``breaker_cooldown_ms`` one probe group is let through — success
    closes the breaker, failure re-opens it.  ``swap_params`` resets
    the breaker (new parameters deserve a fresh chance).

    ``degrade_pressure`` — the ladder's degradation rung: when a drained
    queue's fill fraction reaches this threshold and ``subset_mode`` is
    ``"dependency"``, eligible groups are served through the cheaper
    head-only subset forward for that step (no host-side closure
    extraction) — the engine degrades before it sheds.

    ``batch_window_ms`` / ``batch_max_size`` — the batching window: with
    a positive window the serve loop holds the queue open for up to
    ``batch_window_ms`` after the *oldest* queued request was admitted,
    so bursts coalesce into one compiled forward per fingerprint group
    instead of one per wake-up.  The window closes early when the queue
    reaches ``batch_max_size`` requests (``None`` — no size cap) or when
    the earliest queued deadline would expire before the window ends —
    a request is *never* held past its ``deadline_ms``.  ``0.0`` (the
    default) keeps the pre-window behavior: the loop drains whatever is
    queued the moment it wakes.

    Example::

        engine = HGNNServeEngine(
            spec=ExecutorSpec(device="cuda"),
            policy=ServePolicy(subset_threshold=0.25, max_queue=256,
                               backpressure="reject", deadline_ms=500.0,
                               tenant_rate=100.0, tenant_burst=20))
    """

    subset_threshold: float = 0.5
    subset_mode: str = "head"
    dependency_threshold: float = 0.75
    bucket_min: int = 8
    max_queue: int = 1024
    backpressure: str = "block"
    deadline_ms: Optional[float] = None
    tenant_rate: Optional[float] = None
    tenant_burst: Optional[int] = None
    max_retries: int = 2
    retry_backoff_ms: float = 25.0
    retry_backoff_cap_ms: float = 1000.0
    breaker_threshold: int = 5
    breaker_cooldown_ms: float = 500.0
    degrade_pressure: float = 0.8
    batch_window_ms: float = 0.0
    batch_max_size: Optional[int] = None

    def __post_init__(self):
        """Validate every knob at construction (fail fast, like the spec)."""
        if not 0.0 <= self.subset_threshold <= 1.0:
            raise ValueError(
                f"subset_threshold must be in [0, 1], got "
                f"{self.subset_threshold}")
        if self.subset_mode not in _SUBSET_MODES:
            raise ValueError(
                f"subset_mode={self.subset_mode!r} not in {_SUBSET_MODES}")
        if not 0.0 <= self.dependency_threshold <= 1.0:
            raise ValueError(
                f"dependency_threshold must be in [0, 1], got "
                f"{self.dependency_threshold}")
        if self.bucket_min < 1:
            raise ValueError(f"bucket_min must be >= 1, got {self.bucket_min}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.backpressure not in _BACKPRESSURE:
            raise ValueError(
                f"backpressure={self.backpressure!r} not in {_BACKPRESSURE}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0 (or None to disable), got "
                f"{self.deadline_ms}")
        if self.tenant_rate is not None and self.tenant_rate < 0:
            raise ValueError(
                f"tenant_rate must be >= 0 (or None to disable), got "
                f"{self.tenant_rate}")
        if self.tenant_burst is not None:
            if self.tenant_rate is None:
                raise ValueError(
                    "tenant_burst without tenant_rate: set tenant_rate "
                    "(0 is legal — burst-only admission) to enable quotas")
            if self.tenant_burst < 1:
                raise ValueError(
                    f"tenant_burst must be >= 1, got {self.tenant_burst}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_ms < 0:
            raise ValueError(
                f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}")
        if self.retry_backoff_cap_ms < self.retry_backoff_ms:
            raise ValueError(
                f"retry_backoff_cap_ms ({self.retry_backoff_cap_ms}) must "
                f"be >= retry_backoff_ms ({self.retry_backoff_ms})")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}")
        if self.breaker_cooldown_ms < 0:
            raise ValueError(
                f"breaker_cooldown_ms must be >= 0, got "
                f"{self.breaker_cooldown_ms}")
        if not 0.0 < self.degrade_pressure <= 1.0:
            raise ValueError(
                f"degrade_pressure must be in (0, 1], got "
                f"{self.degrade_pressure}")
        if self.batch_window_ms < 0:
            raise ValueError(
                f"batch_window_ms must be >= 0 (0 disables the batching "
                f"window), got {self.batch_window_ms}")
        if self.batch_max_size is not None:
            if self.batch_max_size < 1:
                raise ValueError(
                    f"batch_max_size must be >= 1 (or None for no size "
                    f"cap), got {self.batch_max_size}")
            if self.batch_window_ms <= 0:
                raise ValueError(
                    "batch_max_size without a batching window: set "
                    "batch_window_ms > 0 (the size cap closes an open "
                    "window early; with no window there is nothing to "
                    "close)")

    @property
    def effective_burst(self) -> int:
        """The resolved token-bucket capacity when quotas are enabled:
        ``tenant_burst`` if set, else ``max(1, ceil(tenant_rate))``."""
        if self.tenant_burst is not None:
            return self.tenant_burst
        return max(1, math.ceil(self.tenant_rate or 0.0))
