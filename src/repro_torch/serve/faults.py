"""Fault injection for the serving tier, plus the failure taxonomy.

The serving engine's recovery machinery (retries, circuit breaker,
deadline shedding — see ``serve/hgnn.py``) is only trustworthy if it can
be *driven through* every failure it claims to survive.  This module is
the driver: a :class:`FaultInjector` raises scripted or probabilistic
exceptions — and injects latency — at named sites inside the engine's
serving path; the engine cannot tell an injected fault from a real one,
which is the point.  Framework-free: the JAX package's module, copied so
the port imports none of it.

Sites (``FaultInjector.SITES``):

* ``"extract"``       — before the k-hop dependency-closure extraction
  (dependency-mode subset serving only);
* ``"forward"``       — before the compiled forward (any mode: full,
  head-only subset, or dependency);
* ``"host_transfer"`` — before the device->host logits transfer.

The engine takes an injector at construction (``HGNNServeEngine(...,
faults=FaultInjector())``) behind a no-op default: production engines
pay one ``None`` check per site.

The module also owns the failure *classification* the recovery ladder
dispatches on: :func:`is_transient` decides retry-with-backoff
(transient: the next attempt may succeed — preemptions, flaky
transports, injected :class:`TransientFault`) versus fail-fast
(permanent: a mismatched parameter dict will not fix itself).

Example::

    inj = FaultInjector(seed=0)
    inj.inject("forward", exc=TransientFault("preempted"), times=2)
    inj.inject("host_transfer", latency_ms=5.0)
    engine = HGNNServeEngine(spec=ExecutorSpec(device="cpu"), faults=inj)
    ...
    assert inj.counts["forward"] >= 2
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

SITES = ("extract", "forward", "host_transfer")


class TransientFault(RuntimeError):
    """A failure whose retry may succeed (preemption, flaky transport).

    The canonical *transient* exception: the engine retries it with
    capped exponential backoff (``ServePolicy.max_retries``).  Raise it
    from a :class:`FaultInjector` rule to exercise the retry path.
    """


class PermanentFault(RuntimeError):
    """A failure that no retry will fix (bad params, corrupt packing).

    The canonical *permanent* exception: the engine fails the group's
    futures immediately and feeds the circuit breaker.
    """


TRANSIENT_TYPES = (TransientFault, TimeoutError, ConnectionError, OSError)


def is_transient(exc: BaseException) -> bool:
    """Classify a serving failure: ``True`` means retry may succeed.

    Transient: :data:`TRANSIENT_TYPES` (injected :class:`TransientFault`,
    timeouts, connection/OS errors — the preemption/flaky-transport
    shapes) or any exception carrying a truthy ``transient`` attribute.
    Everything else — type/shape/key errors from a mismatched params dict,
    :class:`PermanentFault` — is permanent: retrying would burn
    ``step()`` time re-raising the same error.

    Example::

        is_transient(TransientFault("preempted"))  # True
        is_transient(TypeError("bad params"))      # False
    """
    if isinstance(exc, TRANSIENT_TYPES):
        return True
    return bool(getattr(exc, "transient", False))


@dataclasses.dataclass
class _Rule:
    """One injection rule at one site (internal).

    ``plan`` is the scripted mode: a per-call list consumed left to
    right (``None`` entries fire nothing).  Otherwise the rule applies
    to calls ``after <= call_index`` while ``times`` (``None`` =
    forever) remain, with probability ``p`` (``None`` = always).
    """

    exc: Optional[BaseException] = None
    latency_ms: float = 0.0
    times: Optional[int] = None
    after: int = 0
    p: Optional[float] = None
    plan: Optional[List[Optional[BaseException]]] = None


class FaultInjector:
    """Scripted/probabilistic exceptions and latency at named sites.

    Rules are registered with :meth:`inject` (count/probability driven)
    or :meth:`script` (an explicit per-call plan); the engine calls
    :meth:`fire` at each site.  Latency is applied before any exception,
    so a rule can model a slow *and* failing dependency.  All state is
    lock-guarded — the background serving loop and direct ``step()``
    callers may fire concurrently.

    Example::

        inj = FaultInjector(seed=7)
        inj.script("forward", [None, TransientFault("boom")])
        inj.inject("extract", p=0.25, exc=TransientFault("flaky"))
    """

    SITES = SITES

    def __init__(self, seed: int = 0):
        """A fresh injector with no rules; ``seed`` drives the rng the
        probabilistic rules draw from (chaos runs are replayable)."""
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {s: [] for s in SITES}
        self._calls: Dict[str, int] = {s: 0 for s in SITES}
        self._raised: Dict[str, int] = {s: 0 for s in SITES}

    @staticmethod
    def _check_site(site: str) -> None:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (sites: {SITES})")

    def inject(
        self,
        site: str,
        *,
        exc: Optional[BaseException] = None,
        latency_ms: float = 0.0,
        times: Optional[int] = None,
        after: int = 0,
        p: Optional[float] = None,
    ) -> "FaultInjector":
        """Register a rule at ``site``; returns ``self`` for chaining.

        ``exc`` is raised (after sleeping ``latency_ms``) on every
        matching call: calls with index >= ``after``, at most ``times``
        firings (``None`` = unbounded), each with probability ``p``
        (``None`` = always).  A rule with ``exc=None`` injects latency
        only.

        Example::

            inj.inject("forward", exc=TransientFault("boom"), times=3)
            inj.inject("host_transfer", latency_ms=50.0)
        """
        self._check_site(site)
        if latency_ms < 0:
            raise ValueError(f"latency_ms must be >= 0, got {latency_ms}")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        with self._lock:
            self._rules[site].append(
                _Rule(exc=exc, latency_ms=float(latency_ms), times=times, after=after, p=p)
            )
        return self

    def script(self, site: str, plan: List[Optional[BaseException]]) -> "FaultInjector":
        """Register an explicit per-call plan at ``site``: entry ``i``
        is raised on call ``i`` (``None`` = no fault); calls past the
        end of the plan fire nothing.  Returns ``self``.

        Example::

            inj.script("forward", [TransientFault("1st"), None])
        """
        self._check_site(site)
        with self._lock:
            self._rules[site].append(_Rule(plan=list(plan)))
        return self

    def fire(self, site: str) -> None:
        """The engine-side hook: apply every matching rule at ``site``
        (sleep injected latency, then raise the first scripted or
        sampled exception).  No rules -> a counter increment only."""
        self._check_site(site)
        sleep_ms = 0.0
        raise_exc: Optional[BaseException] = None
        with self._lock:
            idx = self._calls[site]
            self._calls[site] += 1
            for rule in self._rules[site]:
                if rule.plan is not None:
                    exc = rule.plan[idx] if idx < len(rule.plan) else None
                    if exc is not None and raise_exc is None:
                        raise_exc = exc
                    continue
                if idx < rule.after:
                    continue
                if rule.times is not None and rule.times <= 0:
                    continue
                if rule.p is not None and self._rng.random() >= rule.p:
                    continue
                sleep_ms += rule.latency_ms
                if rule.exc is not None and raise_exc is None:
                    raise_exc = rule.exc
                    if rule.times is not None:
                        rule.times -= 1
                elif rule.exc is None and rule.times is not None:
                    rule.times -= 1
            if raise_exc is not None:
                self._raised[site] += 1
        if sleep_ms > 0.0:
            time.sleep(sleep_ms / 1e3)
        if raise_exc is not None:
            raise raise_exc

    @property
    def counts(self) -> Dict[str, int]:
        """Calls observed per site (``{"extract": 0, "forward": 4, ...}``)."""
        with self._lock:
            return dict(self._calls)

    @property
    def raised(self) -> Dict[str, int]:
        """Exceptions actually raised per site (subset of :attr:`counts`)."""
        with self._lock:
            return dict(self._raised)

    def reset(self) -> None:
        """Drop every rule and zero the counters (rng state is kept)."""
        with self._lock:
            self._rules = {s: [] for s in SITES}
            self._calls = {s: 0 for s in SITES}
            self._raised = {s: 0 for s in SITES}
