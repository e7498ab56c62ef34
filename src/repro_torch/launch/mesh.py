"""Meshes of ranks for sharded HGNN execution, sized from the devices
that exist.

The port runs a mesh in one process: a mesh is an ordered array of ranks,
each a ``torch.device``, and several ranks may share one physical device.
``device_pool`` lists the ranks a device type offers: every CUDA device
(``cuda:0 .. cuda:N-1``), or the one CPU.  With
``REPRO_TORCH_VIRTUAL_DEVICES=n`` set it returns ``n`` ranks dealt
round-robin over those physical devices, so a 4-rank plan runs on one
card or on the CPU (the counterpart of XLA's
``--xla_force_host_platform_device_count``).

``make_mesh_for`` is the one constructor, as in the JAX package
(``repro/launch/mesh.py``); the LM meshes ``make_production_mesh`` and
``make_debug_mesh`` build on it with the reference's axis names.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

VIRTUAL_DEVICES_ENV = "REPRO_TORCH_VIRTUAL_DEVICES"


def _balanced_shape(n: int, k: int) -> Tuple[int, ...]:
    """Factor ``n`` devices into ``k`` near-equal axis sizes.

    Prime factors of ``n`` are dealt largest-first onto the currently
    smallest axis, so 256 over 2 axes is (16, 16) and 512 over 3 is
    (8, 8, 8).  Deterministic; the product is always exactly ``n``.
    """
    if n < 1 or k < 1:
        raise ValueError(f"need n >= 1 devices and k >= 1 axes, got ({n}, {k})")
    factors = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1
    if m > 1:
        factors.append(m)
    shape = [1] * k
    for f in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= f
    return tuple(sorted(shape, reverse=True))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out over named axes: ``devices`` is an object array of
    ``torch.device`` shaped by the axes, ``axis_names`` their names."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def ranks(self) -> List[torch.device]:
        """The ranks in row-major order (rank ``i`` is ``ranks[i]``)."""
        return list(self.devices.reshape(-1))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))


def device_pool(device="cuda") -> List[torch.device]:
    """The ranks a device type offers, in order.

    A CUDA spec gives ``cuda:0 .. cuda:N-1`` and a CPU spec the one CPU;
    with ``REPRO_TORCH_VIRTUAL_DEVICES=n`` set, ``n`` ranks dealt
    round-robin over those devices.  Raises when a CUDA spec finds no
    CUDA device.

    Example::

        device_pool("cpu")  # [device(type='cpu')], or n of them
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(f"device pool of {device!r}: no CUDA device is available")
        physical = [torch.device("cuda", i) for i in range(count)]
    elif dev.type == "cpu":
        physical = [torch.device("cpu")]
    else:
        raise ValueError(f"device pool of {device!r}: not a cuda or cpu device")
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return physical
    n = int(raw)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={raw!r} must be a positive integer")
    return [physical[i % len(physical)] for i in range(n)]


def make_mesh_for(devices: Optional[Sequence] = None,
                  shard_axes: Sequence[str] = ("dev",),
                  shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Mesh over the ranks that exist (or a pinned subset).

    ``devices=None`` takes ``device_pool("cuda")``; the serving engine
    passes an explicit subset to pin a tenant to a device group.
    ``shape=None`` sizes the axes from the rank count
    (``_balanced_shape``); an explicit shape must multiply out to it.
    """
    devs = device_pool("cuda") if devices is None else [torch.device(d) for d in devices]
    axes = tuple(shard_axes)
    if not axes:
        raise ValueError("shard_axes must name at least one mesh axis")
    if shape is None:
        shape = _balanced_shape(len(devs), len(axes))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != len(devs):
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devs)} devices over "
            f"axes {axes}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Production axis names over every rank of ``device``'s pool.

    Axes: 'data' carries FSDP + batch, 'model' carries TP/EP; with
    ``multi_pod`` a leading 'pod' axis of 2 is pure data parallelism.  A
    256-rank pool resolves to 16 x 16; smaller pools size down.
    """
    if multi_pod:
        n = len(device_pool(device))
        if n % 2:
            raise ValueError(f"multi_pod needs an even device count, got {n}")
        return make_mesh_for(device_pool(device), shard_axes=("pod", "data", "model"),
                             shape=(2,) + _balanced_shape(n // 2, 2))
    return make_mesh_for(device_pool(device), shard_axes=("data", "model"))


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` ranks of
    ``device``'s pool."""
    pool = device_pool(device)
    if data * model > len(pool):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                         f"the pool of {device!r} has {len(pool)}")
    return make_mesh_for(pool[:data * model], shard_axes=("data", "model"),
                         shape=(data, model))
