"""Fault tolerance: retrying runner, straggler watchdog, elastic restarts,
the JAX package's ``repro.train.fault_tolerance``.

``FaultTolerantRunner`` wraps the train loop:

  * **checkpoint/restart**: periodic atomic checkpoints; on a step failure
    (a device error, a preemption, an injected fault) the runner restores
    the newest checkpoint and replays.  The data pipeline is counter-based
    (``train/data.py``), so replayed steps see identical batches.
  * **straggler mitigation**: a step slower than ``straggler_factor``
    times the EWMA of recent step times is counted and reported to
    ``on_straggler``.
  * **non-finite loss**: raises ``FloatingPointError``, which counts as a
    failure and restores.

``ElasticController`` rebuilds a mesh from the ranks that remain and moves
checkpointed (logically global) state onto it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh, device_pool, make_mesh_for
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.tree import flatten_up_to, tree_flatten, tree_unflatten


@dataclasses.dataclass
class RunnerStats:
    """Counters of one ``FaultTolerantRunner``."""

    steps_done: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0
    last_loss: float = float("nan")


class FaultTolerantRunner:
    """Run ``step_fn(state, *data_fn(step))`` for a range of steps with
    checkpoints every ``ckpt_every`` steps, up to ``max_retries``
    consecutive retries of a failing step (each from the newest checkpoint,
    or from the state in memory before the first one), and the EWMA
    straggler watchdog.  ``fault_hook(step)`` runs before each step (fault
    injection)."""

    def __init__(
        self,
        step_fn: Callable,  # (state, tok, tgt) -> (state, metrics)
        data_fn: Callable,  # step -> (tok, tgt), or (per-rank shards, None)
        ckpt: CheckpointManager,
        ckpt_every: int = 50,
        max_retries: int = 3,
        straggler_factor: float = 3.0,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        fault_hook: Optional[Callable[[int], None]] = None,
    ):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.fault_hook = fault_hook
        self.stats = RunnerStats()
        self._ewma = None

    def run(self, state: Any, start_step: int, num_steps: int,
            specs: Any = None, mesh: Optional[Mesh] = None) -> Tuple[Any, RunnerStats]:
        """Run steps ``[start_step, start_step + num_steps)``; returns the
        final state and the counters.  A restore places the state by
        ``mesh`` and ``specs`` (``CheckpointManager.restore``)."""
        step = start_step
        retries = 0
        while step < start_step + num_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                tok, tgt = self.data_fn(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, tok, tgt)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                if self._ewma is not None and dt > self.straggler_factor * self._ewma:
                    self.stats.stragglers += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                self._ewma = dt if self._ewma is None else 0.9 * self._ewma + 0.1 * dt
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                self.stats.last_loss = loss
                self.stats.steps_done += 1
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, specs=None, extra={"step": step})
            except Exception:
                self.stats.failures += 1
                retries += 1
                if retries > self.max_retries:
                    raise
                restored = self.ckpt.restore_latest(state, mesh=mesh, specs=specs)
                if restored is not None:
                    step, state, _ = restored
                    self.stats.restores += 1
                # else: replay from the state in memory (no checkpoint yet)
        return state, self.stats


class ElasticController:
    """Rebuild a mesh after losing ranks and move state onto it.

    ``make_mesh`` takes the first ``num_devices`` ranks of ``device``'s
    pool (``launch.mesh.device_pool``) as a ``(num_devices /
    model_parallel, model_parallel)`` mesh, whose data ranks the train
    step then splits the batch over; ``reshard`` puts the state where that
    step keeps it.  State must be whole on the host or checkpointed."""

    def __init__(self, axis_names=("data", "model"), device="cuda"):
        self.axis_names = tuple(axis_names)
        self.device = device

    def make_mesh(self, num_devices: int, model_parallel: int = 1) -> Mesh:
        """A ``(num_devices / model_parallel, model_parallel)`` mesh."""
        if num_devices % model_parallel:
            raise ValueError(f"{num_devices} ranks do not split into model-parallel "
                             f"groups of {model_parallel}")
        pool = device_pool(self.device)
        if num_devices > len(pool):
            raise ValueError(f"{num_devices} ranks asked, the pool has {len(pool)}")
        return make_mesh_for(pool[:num_devices], shard_axes=self.axis_names,
                             shape=(num_devices // model_parallel, model_parallel))

    def reshard(self, tree: Any, mesh: Mesh, specs: Any) -> Any:
        """``tree`` through the host onto ``mesh``: each leaf whole on the
        rank of its spec's first shard (``mesh.ranks[0]``)."""
        leaves, treedef = tree_flatten(tree)
        flatten_up_to(treedef, specs)  # the specs must have the tree's structure
        return tree_unflatten(treedef, [torch.as_tensor(x).detach().cpu().to(mesh.ranks[0])
                                        for x in leaves])
