"""ExecutorSpec: the one declaration of *how* HGNN work executes in the port.

The JAX package's spec names a ``kernel_backend`` (``interpret`` |
``pallas``) that has no meaning in PyTorch.  Here ``device`` takes its
place: on ``"cuda"`` the banded NA path (and the device SGB composer)
launches the hand-written CUDA kernels, on ``"cpu"`` it runs their plain
versions.  ``na_executor="jnp"`` keeps the reference's name for the
segment-sum executor (plain PyTorch scatters over global edge lists).
The other validation invariants stay: ``banded`` implies packing and
requires ``restructure``, and unknown values raise ``ValueError``.  Values the port does not run yet raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
    needs.

    Example::

        ExecutorSpec(na_executor="banded", device="cpu").pack  # True
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
        if self.shard != "none":
            raise NotImplementedError(
                f"shard={self.shard!r} (multi-device execution) is not "
                "ported yet: ROADMAP item M9")
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
