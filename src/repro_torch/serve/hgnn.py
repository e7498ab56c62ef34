"""Async multi-tenant HGNN serving on compiled sessions.

GDR-HGNN and HiHGNN (PAPERS.md) frame the accelerator frontend as a
service shared across models and requests; ``HGNNServeEngine`` is that
path in software, here over the port's ``repro_torch.api`` on an H100
(or the CPU, where the kernels' plain versions run).  Tenants
``register`` a (graph, targets, model config)
— compiled once through the shared ``repro_torch.api.Session``, so every tenant
over the same topology reuses the cached semantic graphs, restructure
permutations, and ``PackedEdges`` — and then submit inference
``HGNNRequest``s for target-type vertices.

Serving has three layers:

* **Admission** — ``submit()`` validates node ids (dtype/bounds, so a bad
  request fails at the edge, never mid-batch), stamps the admission time,
  and enqueues against a bounded queue (``ServePolicy.max_queue``) with a
  block-or-reject backpressure policy; it returns a future per request
  immediately.
* **Batching** — ``step()`` drains the queue grouped by graph
  fingerprint: requests against one registration batch through a single
  compiled forward (the node-classification analogue of continuous
  batching), and when every request in a group names explicit node ids
  whose union covers at most ``ServePolicy.subset_threshold`` of the
  target vertices, the group is served by one *subset forward*: head-only
  (``CompiledHGNN.forward_subset`` — full message passing, classifier
  head and host transfer only over the union of requested rows) or, with
  ``ServePolicy.subset_mode="dependency"``, the vertex-centric executor
  (``forward_subset(mode="dependency")`` — message passing over the
  union's k-hop dependency closure, compute and memory bounded by the
  receptive field; falls back to the full forward when the closure covers
  more than ``ServePolicy.dependency_threshold`` of the graph).
  Same-topology tenants run back-to-back so the session's cached frontend
  products stay hot.
* **The loop** — ``run()`` drives ``step()`` from a background thread so
  submitters never block on compute; ``stop()`` drains and joins.  With
  a positive ``ServePolicy.batch_window_ms`` the loop holds the queue
  open for up to the window after the oldest admission — re-arming its
  timed wait on every submit notification — so bursts coalesce into
  fewer, fuller compiled forwards; the window closes early when the
  queue reaches ``batch_max_size`` or when the earliest queued deadline
  would expire mid-window (a request is never held past its SLO).
  ``swap_params()`` atomically installs freshly trained parameters into a
  live registration, bumping a version stamped on every response, and
  ``swap_graph()`` installs a ``GraphDelta``-mutated topology the same way
  (``Session.compile_delta``: cache migration, incremental SGB, the
  block-splice repack).  ``register(..., device_group=)`` pins a tenant
  to a group of ranks on a sharded session (``ExecutorSpec(shard=...)``):
  its full forwards run the sharded executor over that group, and
  ``swap_graph`` keeps the group.

``register()`` returns a :class:`TenantHandle` — the per-tenant surface
(``submit`` / ``swap_params`` / ``swap_graph`` / ``stats``) that replaces
name-string dispatch; the engine's string-keyed ``swap_params(name, ...)``
and ``swap_graph(name, ...)`` remain as thin delegating shims that emit
``DeprecationWarning``.

On top of those sits the **fault-tolerance layer** — the invariant it
maintains is *an admitted request's future always resolves*: to a
response, a ``DeadlineExceeded``, or the classified serving error.

* **Deadlines** — every request carries a latency SLO
  (``HGNNRequest.deadline_ms``, defaulting to
  ``ServePolicy.deadline_ms``).  A deadline already expired at ``submit``
  fails its future immediately; ``step()`` re-checks remaining budget
  when forming (and retrying) groups, so a stale request never rides —
  and never slows — a batch whose result nobody will use.
* **Per-tenant quotas** — token-bucket admission per registration
  (``ServePolicy.tenant_rate``/``tenant_burst``): a hot tenant runs out
  of tokens and gets ``QuotaExceeded`` at the edge instead of filling
  the shared queue and starving every other registration.
* **Retry + circuit breaker** — a serve-group failure is classified
  transient vs permanent (``serve/faults.py``); transient failures are
  retried with capped exponential backoff, and ``breaker_threshold``
  consecutive failures open a per-registration circuit breaker that
  fails the tenant's requests fast (``CircuitOpen``) until a cooldown
  probe succeeds — a tenant with broken hot-swapped params stops
  burning ``step()`` time.
* **Degradation ladder** — under queue pressure
  (``ServePolicy.degrade_pressure``) the engine first *degrades*
  (dependency-mode subset groups are served through the cheaper
  head-only forward) before it *sheds* (quota/backpressure rejections).
* **Fault injection** — a ``FaultInjector`` (``serve/faults.py``) can be
  threaded through the engine (no-op default) to raise scripted or
  probabilistic exceptions — and inject latency — at the named sites
  ``extract``/``forward``/``host_transfer``; the chaos tests
  (``tests/test_torch_serve_hgnn.py``) drive every recovery path through
  it.

Each group ends in one synchronising device-to-host copy of its logits,
the port's ``block_until_ready``.

Every response carries its queueing and compute latency separately;
``stats()`` reports batching factors, subset-vs-full forward counts,
latency percentiles, per-tenant served/rejected/deadline splits,
breaker states, and the session's warm-cache hit rate.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import warnings
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from repro_torch.api.session import (CompiledHGNN, Session, canonical_node_ids,
                                     device_features)
from repro_torch.api.spec import ExecutorSpec, ServePolicy
from repro_torch.core.hgnn.models import HGNNConfig
from repro_torch.hetero.delta import GraphDelta
from repro_torch.hetero.graph import HetGraph
from repro_torch.serve.faults import FaultInjector, is_transient


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when the admission queue is full and the
    engine's ``ServePolicy.backpressure`` is ``"reject"``.

    Example::

        try:
            engine.submit(req)
        except AdmissionError:
            ...  # shed load / retry with backoff
    """


class QuotaExceeded(AdmissionError):
    """Raised by ``submit`` when a tenant's token bucket is empty
    (``ServePolicy.tenant_rate``/``tenant_burst``): the hot tenant sheds
    its own load at the edge; the shared queue — and every other
    tenant — is untouched.

    Example::

        try:
            engine.submit(req)
        except QuotaExceeded:
            ...  # this tenant is over its rate; back off
    """


class DeadlineExceeded(RuntimeError):
    """A request's latency SLO expired before its group entered a
    compiled forward.  Delivered through the request's future — at
    ``submit`` when the deadline is already gone, or at group formation
    inside ``step()`` (a stale request never rides a batch).

    Example::

        fut = engine.submit(HGNNRequest(0, "acm", nodes=ids,
                                        deadline_ms=50.0))
        try:
            resp = fut.result(timeout=30)
        except DeadlineExceeded:
            ...  # shed: re-submit with a fresh budget or give up
    """


class CircuitOpen(RuntimeError):
    """A registration's circuit breaker is open: ``breaker_threshold``
    consecutive serve failures tripped it, and the cooldown probe has
    not yet succeeded.  Requests for that registration fail fast with
    this error — no forward is attempted — while every other tenant
    keeps serving.

    Example::

        try:
            fut.result(timeout=30)
        except CircuitOpen:
            handle.swap_params(good_params)  # also resets the breaker
    """


class _TokenBucket:
    """Per-registration admission quota (engine-lock-guarded)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)  # starts full: burst-first semantics
        self.stamp = now

    def refill(self, now: float) -> None:
        self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def take(self, n: int) -> None:
        self.tokens -= n


class _Breaker:
    """Per-registration circuit breaker (engine-lock-guarded).

    States: ``closed`` (serving normally) -> ``open`` (threshold
    consecutive failures; fail fast) -> ``half_open`` (cooldown elapsed;
    exactly one probe group allowed) -> ``closed`` on probe success or
    back to ``open`` on probe failure.
    """

    __slots__ = ("state", "consecutive", "opened_at", "last_error")

    def __init__(self):
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = 0.0
        self.last_error: Optional[BaseException] = None

    def allow(self, now: float, cooldown_s: float) -> bool:
        """Whether a serve attempt may proceed (transitions open ->
        half_open when the cooldown has elapsed: the probe)."""
        if self.state == "closed":
            return True
        if self.state == "open" and now - self.opened_at >= cooldown_s:
            self.state = "half_open"
            return True  # the one probe
        return False  # open (cooling down) or a probe already in flight

    def record_success(self) -> None:
        self.state = "closed"
        self.consecutive = 0
        self.last_error = None

    def record_failure(self, exc: BaseException, threshold: int, now: float) -> None:
        self.consecutive += 1
        self.last_error = exc
        if self.state == "half_open" or self.consecutive >= threshold:
            self.state = "open"
            self.opened_at = now


@dataclasses.dataclass
class _TenantStats:
    """Per-registration serving counters (engine-lock-guarded)."""

    submitted: int = 0
    served: int = 0
    rejected_quota: int = 0
    deadline_exceeded: int = 0
    failures: int = 0
    retries: int = 0
    breaker_fastfails: int = 0
    batches: int = 0  # successful compiled forwards that served this tenant
    batch_requests: int = 0  # requests those forwards carried (mean = /batches)
    window_timeouts: int = 0  # drains whose batching window ran to its full length
    early_closes: int = 0  # drains closed early: size cap or approaching deadline


@dataclasses.dataclass
class HGNNRequest:
    """One inference request: classify ``nodes`` (target-type vertex ids)
    of a registered graph.  ``nodes=None`` asks for every target vertex.

    ``deadline_ms`` is the request's latency SLO measured from
    admission (``None`` falls back to ``ServePolicy.deadline_ms``): if
    it expires before the request's group enters a compiled forward,
    the future fails with :class:`DeadlineExceeded` instead of riding a
    batch.  A value <= 0 is already expired at ``submit`` and fails
    fast there.

    ``graph`` may be left empty when submitting through a
    :class:`TenantHandle` (the handle fills in its registration name);
    ``HGNNServeEngine.submit`` requires it.

    Example::

        handle.submit(HGNNRequest(rid=0, nodes=np.array([3, 14, 15]),
                                  deadline_ms=500.0))
    """

    rid: int
    graph: str = ""  # registration name; "" = filled by a TenantHandle
    nodes: Optional[np.ndarray] = None
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class HGNNResponse:
    """The served result for one :class:`HGNNRequest`.

    ``latency_us`` is admission-to-completion wall time and always equals
    ``queue_us + compute_us`` — the queueing share is what an async
    deployment tunes (more tenants per step() raises it; the subset path
    lowers the compute share).  ``params_version`` is the registration's
    parameter version that produced the logits (see
    ``HGNNServeEngine.swap_params``), and ``mode`` records which forward
    served the request (``"full"``, ``"subset"`` — head-only — or
    ``"dependency"`` — k-hop-closure message passing).

    Example::

        fut = engine.submit(HGNNRequest(0, "acm", nodes=ids))
        resp = fut.result(timeout=30)
        assert resp.predictions.shape == (len(ids),)
    """

    rid: int
    graph: str
    logits: np.ndarray  # (len(nodes), num_classes)
    predictions: np.ndarray  # (len(nodes),) argmax class ids
    latency_us: float  # admission -> completion wall time
    batched_with: int  # requests served by the same forward
    queue_us: float = 0.0  # admission -> service start
    compute_us: float = 0.0  # service start -> completion
    params_version: int = 1  # registration's param version that served it
    mode: str = "full"  # "full" | "subset" | "dependency" forward


@dataclasses.dataclass
class _Registration:
    name: str
    fingerprint: str
    compiled: CompiledHGNN
    graph: HetGraph  # the registered topology
    features: Dict
    params: Dict
    version: int = 1
    subset_mode: Optional[str] = None  # None: the policy's subset_mode
    bucket: Optional[_TokenBucket] = None  # None: quotas disabled
    breaker: _Breaker = dataclasses.field(default_factory=_Breaker)
    tstats: _TenantStats = dataclasses.field(default_factory=_TenantStats)


@dataclasses.dataclass
class _Pending:
    req: HGNNRequest
    nodes: Optional[np.ndarray]  # canonical int32, validated at submit
    t_admit: float
    future: "Future[HGNNResponse]"
    deadline: Optional[float] = None  # absolute perf_counter seconds


def _synchronize(t: torch.Tensor) -> None:
    """Wait until ``t``'s device has computed it (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _deliver(fut: Future, *, result=None, exc: Optional[Exception] = None) -> None:
    # a client cancel() can win the race at any point before delivery;
    # set_result/set_exception on a cancelled future raises, and that
    # must not take down the rest of the drained batch
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class TenantHandle:
    """One registration's serving surface, returned by
    ``HGNNServeEngine.register``.

    The handle closes over its registration name, so call sites stop
    threading name strings through every operation::

        acm = engine.register("acm", graph, ["APA", "PAP"], cfg)
        fut = acm.submit(HGNNRequest(0, nodes=ids))
        acm.swap_params(trained)          # hot-swap parameters
        print(acm.stats()["served"], acm.version)

    The engine's string-keyed ``swap_params(name, ...)`` /
    ``swap_graph(name, ...)`` survive as deprecated shims that delegate
    here.
    """

    __slots__ = ("engine", "name")

    def __init__(self, engine: "HGNNServeEngine", name: str):
        """Bind to ``engine``'s registration ``name`` (``register`` builds
        handles; constructing one directly is fine for an existing
        registration)."""
        self.engine = engine
        self.name = name

    def __repr__(self) -> str:
        """``TenantHandle('acm')`` — the bound registration name."""
        return f"TenantHandle({self.name!r})"

    def _reg(self) -> _Registration:
        """The live registration (engine-lock-guarded lookup)."""
        with self.engine._lock:
            reg = self.engine._registered.get(self.name)
            if reg is None:
                raise KeyError(
                    f"graph {self.name!r} not registered "
                    f"(have {sorted(self.engine._registered)})"
                )
            return reg

    @property
    def compiled(self) -> CompiledHGNN:
        """The registration's compiled model."""
        return self._reg().compiled

    @property
    def version(self) -> int:
        """The registration's current version stamp (bumped by
        ``swap_params``)."""
        return self._reg().version

    @property
    def fingerprint(self) -> str:
        """The registration's current topology fingerprint."""
        return self._reg().fingerprint

    def submit(
        self, requests: Union[HGNNRequest, Sequence[HGNNRequest]]
    ) -> "Union[Future[HGNNResponse], List[Future[HGNNResponse]]]":
        """Submit requests against this registration (see
        ``HGNNServeEngine.submit`` for admission semantics).

        Requests may leave ``graph`` empty — the handle fills in its
        name — but a non-empty ``graph`` naming a *different*
        registration is rejected (use ``engine.submit`` for mixed-tenant
        batches).

        Example::

            fut = handle.submit(HGNNRequest(0, nodes=np.array([3, 7])))
        """
        single = isinstance(requests, HGNNRequest)
        reqs = [requests] if single else list(requests)
        bound = []
        for r in reqs:
            if not r.graph:
                r = dataclasses.replace(r, graph=self.name)
            elif r.graph != self.name:
                raise ValueError(
                    f"request {r.rid}: graph {r.graph!r} does not match "
                    f"this handle's registration {self.name!r} (use "
                    f"engine.submit for mixed-tenant batches)"
                )
            bound.append(r)
        out = self.engine.submit(bound)
        return out[0] if single else out

    def swap_params(self, params: Dict) -> int:
        """Atomically install new parameters; returns the bumped version
        (see the engine docs for in-flight/version semantics).

        Example::

            v = handle.swap_params(out["state"].params)
        """
        return self.engine._do_swap_params(self.name, params)

    def swap_graph(self, delta: GraphDelta, *, warm: bool = False) -> int:
        """Atomically install a delta-mutated topology; returns the
        bumped version.

        The delta flows through the session's incremental frontend path
        (``Session.compile_delta``): warm cache entries for untouched
        metapaths migrate in place (their packings and device copies with
        them), touched semantic graphs recompose incrementally, packings
        splice, and the successor shares the dependency forward's
        signature set — requests whose closures keep their bucket
        signature add no new dependency trace.  In-flight groups are
        unaffected: serving snapshots ``(compiled, features, params,
        version)`` atomically, so each group runs entirely pre- or
        entirely post-swap.  ``warm=True`` additionally runs one full
        forward on the successor before installing it (the spliced
        packings' row views are built and uploaded then, not on the first
        request).

        Example::

            delta = GraphDelta.insert("PS", src, dst)
            v = handle.swap_graph(delta)
        """
        return self.engine._do_swap_graph(self.name, delta, warm=warm)

    def stats(self) -> Dict:
        """This registration's serving counters plus its live version,
        fingerprint, and breaker state (the per-tenant slice of
        ``engine.stats()["tenants"]``).

        Example::

            assert handle.stats()["served"] >= 0
        """
        with self.engine._lock:
            reg = self.engine._registered.get(self.name)
            if reg is None:
                raise KeyError(
                    f"graph {self.name!r} not registered "
                    f"(have {sorted(self.engine._registered)})"
                )
            return _tenant_stats_dict(reg)


def _tenant_stats_dict(reg: _Registration) -> Dict:
    """One registration's stats slice (caller holds the engine lock)."""
    return {
        "submitted": reg.tstats.submitted,
        "served": reg.tstats.served,
        "rejected_quota": reg.tstats.rejected_quota,
        "deadline_exceeded": reg.tstats.deadline_exceeded,
        "failures": reg.tstats.failures,
        "retries": reg.tstats.retries,
        "breaker_fastfails": reg.tstats.breaker_fastfails,
        "batches": reg.tstats.batches,
        "mean_batch_size": (
            reg.tstats.batch_requests / reg.tstats.batches if reg.tstats.batches else 0.0
        ),
        "window_timeouts": reg.tstats.window_timeouts,
        "early_closes": reg.tstats.early_closes,
        "breaker": reg.breaker.state,
        "version": reg.version,
        "fingerprint": reg.fingerprint,
    }


class HGNNServeEngine:
    """Admit requests for many registered graphs; batch by fingerprint.

    Synchronous use (tests, benchmarks) calls ``step()`` directly;
    production-shaped use starts the background admission loop::

        engine = HGNNServeEngine(spec=ExecutorSpec(device="cuda"))
        engine.register("acm", graph, ["APA", "PAP"], cfg)
        engine.run()                                  # background thread
        fut = engine.submit(HGNNRequest(0, "acm", nodes=ids))
        print(fut.result().predictions)
        engine.stop()                                 # drain + join
    """

    def __init__(
        self,
        session: Optional[Session] = None,
        spec: Optional[ExecutorSpec] = None,
        policy: Optional[ServePolicy] = None,
        faults: Optional[FaultInjector] = None,
    ):
        """Build an engine over an existing ``Session`` (to share its
        caches) or a fresh one from ``spec``; ``policy`` tunes admission
        and batching (see ``repro_torch.api.ServePolicy``); ``faults`` threads
        a ``FaultInjector`` through the serving path (chaos testing —
        the default is a no-op)."""
        if session is not None and spec is not None:
            raise ValueError("pass a Session or a spec for a fresh one, not both")
        self.session = session if session is not None else Session(spec)
        self.policy = policy if policy is not None else ServePolicy()
        self.faults = faults
        self._registered: Dict[str, _Registration] = {}
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._queue_drained = threading.Condition(self._lock)
        self._work_ready = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False  # stop() in progress: admission closed
        self._stop_epoch = 0  # bumped by stop(); fails submitters that
        # were blocked on backpressure across it (their consumer is gone)
        self._served = 0
        self._forwards_full = 0
        self._forwards_subset = 0
        self._forwards_dependency = 0
        self._rejected = 0
        self._deadline_exceeded = 0
        self._quota_rejected = 0
        self._retries = 0
        self._breaker_fastfails = 0
        self._degraded_steps = 0
        self._window_timeouts = 0
        self._early_closes = 0
        # bounded: a long-lived engine must not grow a per-request list
        # forever; percentiles come from the most recent window
        self._latencies_us: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._queue_us: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._compute_us: "collections.deque[float]" = collections.deque(maxlen=4096)

    # ---------------------------------------------------------- tenants --
    def register(
        self,
        name: str,
        graph: HetGraph,
        targets: Sequence[str],
        cfg: HGNNConfig,
        *,
        params: Optional[Dict] = None,
        seed: int = 0,
        features: Optional[Dict] = None,
        warm: bool = True,
        device_group: Optional[Sequence] = None,
        subset_mode: Optional[str] = None,
    ) -> TenantHandle:
        """Register a tenant: compile (cache-served through the shared
        session) and pin features + parameters on the session's device.
        ``warm=True`` runs one forward (ending in a sync) so serving
        latency is steady-state: the NA packings' device uploads and the
        kernels' first load happen here.  Returns the tenant's
        :class:`TenantHandle` — the per-registration surface for
        ``submit``/``swap_params``/``swap_graph``/``stats``.

        ``subset_mode`` (``"head"`` or ``"dependency"``) overrides
        ``ServePolicy.subset_mode`` for this tenant alone, so one engine
        can serve a tenant whose closures cover most of its graph head-only
        beside one served over k-hop closures; ``None`` keeps the
        policy's.

        ``device_group`` (sharded sessions only: the engine's
        ``ExecutorSpec.shard`` must not be ``"none"``) pins this tenant's
        forwards to a group of ranks, given as ``torch.device``s or
        indices into ``launch.mesh.device_pool(spec.device)``; tenants
        pinned to disjoint groups run on disjoint ranks.

        Example::

            acm = engine.register("acm", graph, ["APA", "PAP"], cfg)
            fut = acm.submit(HGNNRequest(0, nodes=ids))
        """
        if subset_mode not in (None, "head", "dependency"):
            raise ValueError(f"subset_mode={subset_mode!r} not in "
                             "(None, 'head', 'dependency')")
        with self._lock:
            if name in self._registered:
                raise ValueError(f"graph {name!r} already registered")
        compiled = self.session.compile(graph, targets, cfg, devices=device_group)
        feats = (features if features is not None
                 else device_features(graph, compiled.device))
        if params is None:
            params = compiled.init(seed)
        bucket = None
        if self.policy.tenant_rate is not None:
            bucket = _TokenBucket(
                self.policy.tenant_rate, self.policy.effective_burst, time.perf_counter()
            )
        reg = _Registration(
            name, graph.fingerprint(), compiled, graph, feats, params,
            subset_mode=subset_mode, bucket=bucket
        )
        if warm:
            _synchronize(compiled.forward(params, feats))
        with self._lock:
            if name in self._registered:
                raise ValueError(f"graph {name!r} already registered")
            self._registered[name] = reg
        return TenantHandle(self, name)

    @property
    def registered(self) -> List[str]:
        """Sorted registration names (``engine.registered`` -> ["acm"])."""
        with self._lock:
            return sorted(self._registered)

    def _do_swap_params(self, name: str, params: Dict) -> int:
        """Install new parameters into a live registration and return the
        bumped version (the implementation behind
        ``TenantHandle.swap_params`` and the deprecated string-keyed
        shim).  In-flight requests are served by whichever version a
        ``step()`` snapshots; every response stamps the version that
        produced it, and versions observed in service order are
        monotonically non-decreasing.

        Installing new parameters also resets the registration's
        circuit breaker: if the old ones were the reason it opened, the
        very next request probes the fresh set instead of waiting out
        the cooldown.
        """
        with self._lock:
            reg = self._registered.get(name)
            if reg is None:
                raise KeyError(
                    f"graph {name!r} not registered " f"(have {sorted(self._registered)})"
                )
            reg.params = params
            reg.version += 1
            reg.breaker.record_success()  # new params: breaker resets
            return reg.version

    def swap_params(self, name: str, params: Dict) -> int:
        """Deprecated string-keyed shim: use
        ``TenantHandle.swap_params(params)`` instead (the handle is what
        ``register`` returns).

        Example::

            v = handle.swap_params(out["state"].params)  # preferred
        """
        warnings.warn(
            "HGNNServeEngine.swap_params(name, params) is deprecated; "
            "use the TenantHandle returned by register(): "
            "handle.swap_params(params)",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._do_swap_params(name, params)

    def _do_swap_graph(self, name: str, delta: GraphDelta, *, warm: bool = False) -> int:
        """Apply a ``GraphDelta`` to a live registration and return the
        bumped version (the implementation behind
        ``TenantHandle.swap_graph`` and the deprecated string-keyed
        shim).

        The heavy work — ``Session.compile_delta``'s cache migration,
        incremental SGB, splice repack, and successor compile, and the
        warm forward — runs *outside* the engine lock; the installation of
        ``(graph, compiled, features, fingerprint, version)`` is one
        atomic update under it.  Serving snapshots the same tuple
        atomically per group, so every group runs entirely pre- or
        entirely post-swap and in-flight futures still resolve.  The
        successor's uploads and the loop's launches share the device's
        default stream, so they stay ordered.  A concurrent
        ``swap_graph`` on the same registration loses the race and raises
        ``RuntimeError`` (its delta was computed against a superseded
        topology).

        Feature tensors are carried over unchanged unless the delta adds
        vertices (then the successor graph's zero-extended features are
        uploaded to the model's device).  Like ``swap_params``, a
        successful topology swap resets the circuit breaker.
        """
        with self._lock:
            reg = self._registered.get(name)
            if reg is None:
                raise KeyError(
                    f"graph {name!r} not registered " f"(have {sorted(self._registered)})"
                )
            graph, compiled, params = reg.graph, reg.compiled, reg.params
        successor, new_graph, _ = self.session.compile_delta(compiled, graph, delta)
        if delta.add_vertices:
            feats = device_features(new_graph, successor.device)
        else:
            feats = reg.features
        if warm:
            _synchronize(successor.forward(params, feats))
        with self._lock:
            if reg.compiled is not compiled:
                raise RuntimeError(
                    f"registration {name!r}: a concurrent swap_graph "
                    f"superseded this delta's base topology"
                )
            reg.graph = new_graph
            reg.compiled = successor
            reg.features = feats
            reg.fingerprint = successor.fingerprint
            reg.version += 1
            reg.breaker.record_success()  # fresh topology: breaker resets
            return reg.version

    def swap_graph(self, name: str, delta: GraphDelta, *, warm: bool = False) -> int:
        """Deprecated string-keyed shim: use
        ``TenantHandle.swap_graph(delta)`` instead (the handle is what
        ``register`` returns).

        Example::

            v = handle.swap_graph(GraphDelta.insert("PS", src, dst))
        """
        warnings.warn(
            "HGNNServeEngine.swap_graph(name, delta) is deprecated; "
            "use the TenantHandle returned by register(): "
            "handle.swap_graph(delta)",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._do_swap_graph(name, delta, warm=warm)

    def _fire(self, site: str) -> None:
        """Fault-injection hook: delegate to the engine's injector, a
        no-op when none is configured (the production default)."""
        if self.faults is not None:
            self.faults.fire(site)

    # --------------------------------------------------------- admission --
    def _canonical_nodes(self, reg: _Registration, rid: int, nodes) -> Optional[np.ndarray]:
        """Validate and canonicalize one request's node ids at admission
        (int dtype, 1-D, non-empty, in-bounds — one shared validator
        with ``forward_subset``) so a bad id fails the ``submit`` call,
        never a batch mid-``step``."""
        if nodes is None:
            return None
        return canonical_node_ids(nodes, reg.compiled.num_target, ctx=f"request {rid}: nodes")

    def submit(
        self, requests: Union[HGNNRequest, Sequence[HGNNRequest]]
    ) -> "Union[Future[HGNNResponse], List[Future[HGNNResponse]]]":
        """Validate and enqueue requests; returns one future per request
        (a single future for a single request) that resolves to its
        :class:`HGNNResponse` when a ``step()`` — the background loop's or
        a direct call — serves it.

        The whole batch is validated before any of it is admitted, so a
        bad name or node id cannot leave a half-enqueued batch behind the
        raise.  When the queue is at ``policy.max_queue``, ``"block"``
        backpressure waits for the serving loop to drain capacity;
        ``"reject"`` raises :class:`AdmissionError`.

        With quotas enabled (``ServePolicy.tenant_rate``), each tenant's
        token bucket is checked — atomically across the batch — *before*
        the shared queue: an over-rate tenant raises
        :class:`QuotaExceeded` without consuming queue capacity, so one
        hot tenant cannot starve the others.  A request whose effective
        deadline is already expired (``deadline_ms <= 0``) is admitted
        but its future fails immediately with :class:`DeadlineExceeded`
        — it never touches the queue.

        Example::

            futs = engine.submit([HGNNRequest(0, "acm", nodes=ids),
                                  HGNNRequest(1, "imdb")])
            responses = [f.result(timeout=30) for f in futs]
        """
        single = isinstance(requests, HGNNRequest)
        reqs = [requests] if single else list(requests)
        if not reqs:
            # explicit no-op: nothing to validate, enqueue, or notify —
            # an empty batch must not touch the lock or wake the loop
            return []
        if len(reqs) > self.policy.max_queue:
            with self._lock:
                self._rejected += len(reqs)
            raise AdmissionError(
                f"batch of {len(reqs)} can never fit the admission "
                f"queue (max_queue={self.policy.max_queue})"
            )
        with self._lock:
            if self._draining:
                raise AdmissionError("engine is stopping; admission closed")
            regs = []
            for r in reqs:
                reg = self._registered.get(r.graph)
                if reg is None:
                    raise KeyError(
                        f"request {r.rid}: graph {r.graph!r} not registered "
                        f"(have {sorted(self._registered)})"
                    )
                regs.append(reg)
            # per-tenant token-bucket admission, atomic across the batch:
            # refill every touched bucket, check them all, then consume —
            # a quota raise admits nothing and charges nobody
            if self.policy.tenant_rate is not None:
                now = time.perf_counter()
                share: Dict[str, int] = {}
                by_name: Dict[str, _Registration] = {}
                for r, reg in zip(reqs, regs):
                    share[reg.name] = share.get(reg.name, 0) + 1
                    by_name[reg.name] = reg
                for name, n in share.items():
                    bucket = by_name[name].bucket
                    bucket.refill(now)
                    if bucket.tokens < n:
                        by_name[name].tstats.rejected_quota += n
                        self._quota_rejected += n
                        self._rejected += len(reqs)
                        raise QuotaExceeded(
                            f"tenant {name!r} over its admission rate "
                            f"({bucket.tokens:.1f} tokens for {n} "
                            f"requests; rate={self.policy.tenant_rate}/s "
                            f"burst={self.policy.effective_burst})"
                        )
                for name, n in share.items():
                    by_name[name].bucket.take(n)
        # the O(n) id scans run outside the lock (registrations are never
        # removed): a large batch must not stall the serving loop
        pendings = [
            (r, reg, self._canonical_nodes(reg, r.rid, r.nodes)) for r, reg in zip(reqs, regs)
        ]
        with self._lock:
            epoch = self._stop_epoch
            while len(self._queue) + len(reqs) > self.policy.max_queue:
                if self.policy.backpressure == "reject":
                    self._rejected += len(reqs)
                    raise AdmissionError(
                        f"admission queue full ({len(self._queue)}/{self.policy.max_queue} queued)"
                    )
                if self._draining or self._stop_epoch != epoch:
                    raise AdmissionError("engine is stopping; admission closed")
                # untimed: step()'s drain and stop() notify this
                # condition on every state change, so no poll interval
                self._queue_drained.wait()
            if self._draining or self._stop_epoch != epoch:
                # a submitter that blocked across a stop() must not
                # enqueue into an engine whose consumer is gone — however
                # late it wakes up
                raise AdmissionError("engine is stopping; admission closed")
            now = time.perf_counter()
            futures: List[Future] = []
            enqueued = False
            for r, reg, nodes in pendings:
                fut: "Future[HGNNResponse]" = Future()
                futures.append(fut)
                reg.tstats.submitted += 1
                dl_ms = r.deadline_ms if r.deadline_ms is not None else self.policy.deadline_ms
                if dl_ms is not None and dl_ms <= 0:
                    # already expired at submit: fail fast, never enqueue
                    reg.tstats.deadline_exceeded += 1
                    self._deadline_exceeded += 1
                    _deliver(
                        fut,
                        exc=DeadlineExceeded(
                            f"request {r.rid}: deadline_ms={dl_ms} already expired at submit"
                        ),
                    )
                    continue
                deadline = None if dl_ms is None else now + dl_ms / 1e3
                self._queue.append(_Pending(r, nodes, now, fut, deadline))
                enqueued = True
            if enqueued:
                self._work_ready.notify_all()
        return futures[0] if single else futures

    # ----------------------------------------------------------- serving --
    def _serve_group(
        self,
        reg: _Registration,
        group: List[_Pending],
        compiled: CompiledHGNN,
        features: Dict,
        params: Dict,
        version: int,
        subset_mode: Optional[str] = None,
    ) -> List[HGNNResponse]:
        """One compiled forward for every pending request of one
        registration: a subset path (head-only or k-hop dependency, per
        ``ServePolicy.subset_mode``) when every request names ids whose
        union coverage is within policy, the full-graph forward
        otherwise.  Exactly one synchronising device->host copy and one
        gather per request either way.  ``compiled``/``features``/
        ``params``/``version`` are the caller's atomic registration
        snapshot, so a racing ``swap_params`` serves entirely pre- or
        entirely post-swap.  ``subset_mode`` overrides the tenant's and the policy's for
        this attempt — the degradation ladder passes ``"head"`` under
        queue pressure.  Fault-injection sites (``_fire``): ``extract``
        before the closure extraction, ``forward`` before the compiled
        forward, ``host_transfer`` before the device->host copy."""
        t_start = time.perf_counter()
        nodes_list = [p.nodes for p in group]
        union = None
        if all(n is not None for n in nodes_list):
            union = np.unique(np.concatenate(nodes_list))
            coverage = union.size / max(1, compiled.num_target)
            if coverage > self.policy.subset_threshold:
                union = None
        effective_mode = subset_mode or reg.subset_mode or self.policy.subset_mode
        mode = "full"
        if union is not None:
            # union ids were canonicalized at admission; skip re-scanning
            # them inside the timed serving window
            if effective_mode == "dependency":
                self._fire("extract")
                sub = compiled.dependency_subset(
                    union, bucket_min=self.policy.bucket_min, validate=False
                )
                if sub.coverage <= self.policy.dependency_threshold:
                    self._fire("forward")
                    logits = compiled.forward_subset(
                        params,
                        features,
                        union,
                        bucket_min=self.policy.bucket_min,
                        validate=False,
                        mode="dependency",
                    )
                    mode = "dependency"
                else:
                    union = None  # closure blew up: full forward wins
            else:
                self._fire("forward")
                logits = compiled.forward_subset(
                    params, features, union, bucket_min=self.policy.bucket_min, validate=False
                )
                mode = "subset"
        if union is None:
            self._fire("forward")
            logits = compiled.forward(params, features)
        self._fire("host_transfer")
        host_logits = logits.cpu().numpy()  # waits for the device
        done = time.perf_counter()
        preds_all = None if union is not None else host_logits.argmax(-1)
        responses = []
        compute_us = (done - t_start) * 1e6
        for p in group:
            if union is not None:
                rows = host_logits[np.searchsorted(union, p.nodes)]
                preds = rows.argmax(-1)
            elif p.nodes is None:
                rows, preds = host_logits, preds_all
            else:
                rows = host_logits[p.nodes]  # the one gather per request
                preds = rows.argmax(-1)
            queue_us = (t_start - p.t_admit) * 1e6
            responses.append(
                HGNNResponse(
                    rid=p.req.rid,
                    graph=reg.name,
                    logits=rows,
                    predictions=preds,
                    latency_us=(done - p.t_admit) * 1e6,
                    batched_with=len(group),
                    queue_us=queue_us,
                    compute_us=compute_us,
                    params_version=version,
                    mode=mode,
                )
            )
        with self._lock:
            # stats mutate under the lock: step() may legally run from a
            # direct caller concurrently with the background loop
            if mode == "subset":
                self._forwards_subset += 1
            elif mode == "dependency":
                self._forwards_dependency += 1
            else:
                self._forwards_full += 1
            for r in responses:
                self._latencies_us.append(r.latency_us)
                self._queue_us.append(r.queue_us)
                self._compute_us.append(r.compute_us)
            self._served += len(group)
            reg.tstats.served += len(group)
            reg.tstats.batches += 1
            reg.tstats.batch_requests += len(group)
        return responses

    def _serve_with_recovery(self, name: str, group: List[_Pending], degraded: bool):
        """Serve one registration's group through the recovery ladder;
        returns ``(responses, error)`` where exactly one is ``None`` —
        except the all-futures-expired case, which returns ``(None,
        None)`` (deadline shedding is policy, not a serving failure).

        The ladder, per attempt: (1) shed members whose deadline expired
        while queued (or during a previous attempt's backoff) with
        :class:`DeadlineExceeded`; (2) consult the registration's
        circuit breaker — open fails the group fast with
        :class:`CircuitOpen`, no forward attempted; (3) snapshot
        ``(params, version)`` and serve.  A failure feeds the breaker
        and is classified (``serve/faults.is_transient``): transient
        retries with capped exponential backoff — re-snapshotting
        params, so a ``swap_params`` mid-retry heals the group —
        permanent fails the futures immediately.  ``degraded=True``
        serves dependency-mode groups through the cheaper head-only
        subset forward (the degradation rung)."""
        attempt = 0
        cooldown_s = self.policy.breaker_cooldown_ms / 1e3
        subset_mode = "head" if degraded else None
        while True:
            now = time.perf_counter()
            alive: List[_Pending] = []
            expired: List[_Pending] = []
            for p in group:
                if p.deadline is not None and now >= p.deadline:
                    expired.append(p)
                else:
                    alive.append(p)
            if expired:
                with self._lock:
                    reg = self._registered[name]
                    reg.tstats.deadline_exceeded += len(expired)
                    self._deadline_exceeded += len(expired)
                for p in expired:
                    _deliver(
                        p.future,
                        exc=DeadlineExceeded(
                            f"request {p.req.rid}: deadline expired while "
                            f"queued ({(now - p.t_admit) * 1e3:.1f} ms since "
                            f"admission)"
                        ),
                    )
            group = alive
            if not group:
                return None, None
            with self._lock:
                # snapshot (compiled, features, params, version) as one
                # atomic tuple: a racing swap_params either fully serves
                # this group or the next
                reg = self._registered[name]
                compiled, features = reg.compiled, reg.features
                params, version = reg.params, reg.version
                allowed = reg.breaker.allow(now, cooldown_s)
                if not allowed:
                    reg.tstats.breaker_fastfails += len(group)
                    self._breaker_fastfails += len(group)
                    err: Exception = CircuitOpen(
                        f"registration {name!r}: breaker open after "
                        f"{reg.breaker.consecutive} consecutive failures "
                        f"(last: {reg.breaker.last_error!r})"
                    )
            if not allowed:
                for p in group:
                    _deliver(p.future, exc=err)
                return None, err
            try:
                responses = self._serve_group(
                    reg, group, compiled, features, params, version, subset_mode=subset_mode
                )
            except Exception as e:
                with self._lock:
                    reg.breaker.record_failure(
                        e, self.policy.breaker_threshold, time.perf_counter()
                    )
                    reg.tstats.failures += 1
                    retry = is_transient(e) and attempt < self.policy.max_retries
                    if retry:
                        self._retries += 1
                        reg.tstats.retries += 1
                if retry:
                    attempt += 1
                    backoff_ms = min(
                        self.policy.retry_backoff_cap_ms,
                        self.policy.retry_backoff_ms * 2 ** (attempt - 1),
                    )
                    if backoff_ms > 0:
                        time.sleep(backoff_ms / 1e3)
                    continue
                # permanent (or out of retries): fail THIS group's
                # futures — an admitted request is never silently dropped
                for p in group:
                    _deliver(p.future, exc=e)
                return None, e
            with self._lock:
                reg.breaker.record_success()
            for p, resp in zip(group, responses):
                _deliver(p.future, result=resp)
            return responses, None

    def step(self, window_close: Optional[str] = None) -> List[HGNNResponse]:
        """Drain the queue: one compiled forward per registration serves
        all its queued requests; registrations sharing a topology
        fingerprint run adjacently (their frontend products are the same
        cached objects).  Responses come back in service order, and every
        pending future resolves (to its response, a
        ``DeadlineExceeded``, or the classified serving exception).

        Each group is served through the recovery ladder
        (``_serve_with_recovery``): expired members are shed, the
        breaker is consulted, transient failures retry with backoff.
        One group's serving failure (e.g. hot-swapped parameters with a
        mismatched params dict) is isolated: its futures carry the exception,
        every *other* drained group is still served, and the first error
        re-raises after the drain so synchronous callers see it
        (deadline sheds do not re-raise — shedding is policy working as
        designed).  When the drained queue's fill fraction reaches
        ``ServePolicy.degrade_pressure`` and a drained tenant's subset
        mode (its own, else the policy's) is ``"dependency"``, this step
        serves eligible groups through the cheaper head-only subset
        forward instead — degrade before shed.

        ``window_close`` records *why* the batching window released this
        drain (the serving loop passes ``"timeout"``, ``"size"``, or
        ``"deadline"``; direct callers leave it ``None``) and is
        attributed to every tenant with requests in the drain — the
        ``window_timeouts``/``early_closes`` counters in
        ``stats()["tenants"]``.

        Example::

            engine.submit([...]); responses = engine.step()
        """
        with self._lock:
            if not self._queue:
                return []
            pressure = len(self._queue) / self.policy.max_queue
            queue, self._queue = self._queue, []
            self._queue_drained.notify_all()
            degraded = pressure >= self.policy.degrade_pressure and any(
                (self._registered[p.req.graph].subset_mode or self.policy.subset_mode)
                == "dependency" for p in queue
            )
            if degraded:
                self._degraded_steps += 1
            if window_close in ("timeout", "size", "deadline"):
                timed_out = window_close == "timeout"
                if timed_out:
                    self._window_timeouts += 1
                else:
                    self._early_closes += 1
                for name in {p.req.graph for p in queue}:
                    tstats = self._registered[name].tstats
                    if timed_out:
                        tstats.window_timeouts += 1
                    else:
                        tstats.early_closes += 1
        # fingerprint-major grouping; stable, so per-tenant FIFO holds
        order = sorted(
            range(len(queue)),
            key=lambda i: (self._registered[queue[i].req.graph].fingerprint, queue[i].req.graph),
        )
        responses: List[HGNNResponse] = []
        first_error: Optional[Exception] = None
        i = 0
        while i < len(order):
            name = queue[order[i]].req.graph
            group: List[_Pending] = []
            while i < len(order) and queue[order[i]].req.graph == name:
                group.append(queue[order[i]])
                i += 1
            group_responses, err = self._serve_with_recovery(name, group, degraded)
            if err is not None and first_error is None:
                first_error = err
            if group_responses:
                responses.extend(group_responses)
        if first_error is not None:
            raise first_error
        return responses

    # -------------------------------------------------------------- loop --
    def run(self) -> None:
        """Start the async admission loop: a daemon thread drives
        ``step()`` whenever the queue is non-empty, so ``submit`` returns
        immediately and responses arrive through their futures.

        Example::

            engine.run()
            fut = engine.submit(HGNNRequest(0, "acm", nodes=ids))
            resp = fut.result(timeout=30)
            engine.stop()
        """
        with self._lock:
            if self._running:
                raise RuntimeError("admission loop already running")
            self._running = True
            self._thread = threading.Thread(target=self._loop, name="hgnn-serve-loop", daemon=True)
            thread = self._thread
        thread.start()

    def _hold_window_locked(self, window_s: float) -> str:
        """Hold the batching window open; the caller (the serving loop)
        holds the lock.  Returns why the window released:

        * ``"size"`` — the queue reached ``ServePolicy.batch_max_size``;
        * ``"deadline"`` — the earliest queued deadline would expire
          before the window ends: serve or shed *now*, a request is
          never held past its SLO;
        * ``"timeout"`` — the window ran its full length;
        * ``"stop"`` — ``stop()`` flipped the flag mid-window (drain
          immediately, no window accounting).

        The window is anchored at the *oldest* queued admission, so a
        request's queueing delay is bounded by one window regardless of
        later arrivals.  ``submit`` notifies ``_work_ready`` on every
        enqueue; a wake-up re-checks size/deadline and re-arms the timed
        wait with the *remaining* window — it must not close the window
        just because the condition fired."""
        max_size = self.policy.batch_max_size
        while True:
            if not self._running:
                return "stop"
            if not self._queue:
                # a concurrent direct step() drained the queue mid-window
                return "timeout"
            if max_size is not None and len(self._queue) >= max_size:
                return "size"
            close_at = min(p.t_admit for p in self._queue) + window_s
            deadlines = [p.deadline for p in self._queue if p.deadline is not None]
            if deadlines and min(deadlines) < close_at:
                return "deadline"
            remaining = close_at - time.perf_counter()
            if remaining <= 0:
                return "timeout"
            self._work_ready.wait(timeout=remaining)

    def _loop(self) -> None:
        """Background serving loop: wait for work, drain it, repeat;
        drains whatever is still queued when ``stop()`` flips the flag.
        With ``ServePolicy.batch_window_ms == 0`` the wait is untimed —
        ``submit`` and ``stop`` notify ``_work_ready`` on every state
        change, so the loop never polls.  A positive window inserts
        ``_hold_window_locked`` between first-work and drain: the queue
        stays open up to the window so bursts coalesce, and the close
        reason is threaded into ``step(window_close=...)`` for the
        batching counters."""
        window_s = self.policy.batch_window_ms / 1e3
        while True:
            with self._lock:
                while self._running and not self._queue:
                    self._work_ready.wait()
                if not self._running and not self._queue:
                    return
                close = self._hold_window_locked(window_s) if window_s > 0 else None
            try:
                self.step(window_close=close if close != "stop" else None)
            except Exception:
                # the group's futures already carry the exception; the
                # loop keeps serving the remaining tenants
                continue

    def stop(self) -> None:
        """Stop the admission loop: close admission (a ``submit`` blocked
        on backpressure raises ``AdmissionError`` instead of enqueueing
        into an engine with no consumer), drain everything already
        queued, then join the thread.  Safe to call when the loop never
        ran (the backlog is still drained); after it returns, ``step()``
        on the empty queue returns ``[]`` and admission reopens."""
        with self._lock:
            self._running = False
            self._draining = True
            self._stop_epoch += 1
            self._work_ready.notify_all()
            self._queue_drained.notify_all()
            thread = self._thread
        if thread is not None:
            # join outside the lock: the loop's final step() needs it
            thread.join()
            with self._lock:
                self._thread = None
        try:
            # anything that slipped in before admission closed gets
            # served; a failed group's futures carry its error
            while True:
                try:
                    if not self.step():
                        break
                except Exception:
                    continue
        finally:
            with self._lock:
                self._draining = False

    @property
    def running(self) -> bool:
        """Whether the background admission loop is live."""
        with self._lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict:
        """One serving snapshot: request/forward counts split by mode,
        batching factor, latency percentiles with the queueing-vs-compute
        split, fault-tolerance counters (deadline/quota sheds, retries,
        breaker fast-fails, degraded steps), batching-window counters
        (``window_timeouts``/``early_closes``), a per-tenant breakdown
        (``"tenants"``: submitted/served/rejected splits, per-tenant
        batching — ``batches``/``mean_batch_size`` and the window
        counters — plus the breaker state), and the shared session's
        cache stats.

        Example::

            s = engine.stats()
            print(s["batching_factor"], s["retries"],
                  s["tenants"]["acm"]["breaker"])
        """
        def _pct(deque_, q):
            return float(np.percentile(np.asarray(deque_), q)) if deque_ else None

        with self._lock:
            forwards = self._forwards_full + self._forwards_subset + self._forwards_dependency
            return {
                "graphs_registered": len(self._registered),
                "requests_served": self._served,
                "requests_rejected": self._rejected,
                "requests_deadline_exceeded": self._deadline_exceeded,
                "requests_quota_rejected": self._quota_rejected,
                "retries": self._retries,
                "breaker_fastfails": self._breaker_fastfails,
                "degraded_steps": self._degraded_steps,
                "window_timeouts": self._window_timeouts,
                "early_closes": self._early_closes,
                "queued": len(self._queue),
                "running": self._running,
                "forwards": forwards,
                "forwards_full": self._forwards_full,
                "forwards_subset": self._forwards_subset,
                "forwards_dependency": self._forwards_dependency,
                "batching_factor": self._served / max(1, forwards),
                "latency_us_p50": _pct(self._latencies_us, 50),
                "latency_us_p95": _pct(self._latencies_us, 95),
                "latency_us_p99": _pct(self._latencies_us, 99),
                "queue_us_p50": _pct(self._queue_us, 50),
                "compute_us_p50": _pct(self._compute_us, 50),
                "tenants": {
                    name: _tenant_stats_dict(reg) for name, reg in self._registered.items()
                },
                "session": self.session.stats(),
            }
