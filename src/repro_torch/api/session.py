"""Execution sessions: one compile-and-run surface for the port.

A ``Session`` owns a ``FrontendPipeline`` + ``SemanticGraphCache``
configured from one ``ExecutorSpec``::

    sess = Session(ExecutorSpec(na_executor="banded"))       # device="cuda"
    compiled = sess.compile(graph, targets, HGNNConfig(model="rgat"))
    params = compiled.init(0)
    logits = compiled.forward(params, device_features(graph, "cuda"))
    out = compiled.fit(feats, labels, masks, epochs=20)   # training

``na_executor="jnp"`` runs NA as plain segment sums over global edge
lists instead of the kernels.  ``compiled.forward_subset(params, feats,
ids)`` serves an explicit id subset, head-only or (``mode="dependency"``)
over the ids' k-hop dependency closure (``core/subgraph.py``) — what the
serving engine (``repro_torch.serve.HGNNServeEngine``) calls.
``sess.compile_delta(compiled, graph, delta)`` re-binds a compiled model to
a ``GraphDelta``-mutated graph through the frontend's incremental path.
On a sharded spec (``ExecutorSpec(shard=..., mesh_shape=...)``)
``compile(..., devices=)`` builds a shard plan (memoized) and ``forward``
runs the ``ShardedHGNNExecutor`` over the compile's ranks.

``compile`` runs the frontend (SGB -> Restructure -> packing, cache-served
where possible; with ``sgb_backend="device"`` the SGB steps run on the
spec's device, on kernel K3 for a CUDA device), builds the model's batches
on the spec's device (banded batches, or segment-sum batches for
``na_executor="jnp"``) and binds them to the model in a ``CompiledHGNN``.
Frontend products and compiled models are memoized on the session, so
several models over one graph pack each semantic graph once.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.spec import ExecutorSpec
from repro_torch.core.hgnn.models import HGNN, HGNNConfig
from repro_torch.core.subgraph import DependencyExtractor, DependencySubset
from repro_torch.distributed.hgnn import (ShardedHGNNExecutor, ShardPlan,
                                          build_shard_plan)
from repro_torch.hetero.delta import GraphDelta
from repro_torch.hetero.graph import HetGraph
from repro_torch.launch.mesh import device_pool
from repro_torch.pipeline.cache import SemanticGraphCache
from repro_torch.pipeline.frontend import (DeltaResult, FrontendPipeline,
                                           FrontendResult)


def canonical_node_ids(node_ids, num_target: int, *,
                       ctx: str = "node_ids") -> "np.ndarray":
    """Validate target-vertex ids (integer dtype, 1-D, non-empty, within
    ``[0, num_target)``) and return them as a canonical int32 array.

    The one validator shared by ``CompiledHGNN.forward_subset`` and the
    serving engine's admission path (``ctx`` prefixes the error message,
    e.g. ``"request 3: nodes"``), so the two surfaces cannot drift.

    Example::

        ids = canonical_node_ids([4, 7], compiled.num_target)
    """
    arr = np.asarray(node_ids)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(
            f"{ctx} must be an integer array, got dtype {arr.dtype}")
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError(
            f"{ctx} must be a non-empty 1-D id array, got shape "
            f"{arr.shape}")
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= num_target:
        raise ValueError(
            f"{ctx}: id {lo if lo < 0 else hi} out of bounds "
            f"(valid range [0, {num_target}))")
    return arr.astype(np.int32, copy=False)


def device_features(graph: HetGraph, device="cuda") -> Dict[str, torch.Tensor]:
    """Copy a HetGraph's raw feature dict to ``device`` (the form every
    compiled entry point takes); the card by default, ``"cpu"`` for the
    plain versions.

    Example::

        feats = device_features(graph)           # {"P": (N_P, d_P), ...}
        logits = compiled.forward(params, feats)
    """
    return {t: torch.from_numpy(x).to(device) for t, x in graph.features.items()}


def _changed_product_dsts(old_sem: Dict, new_sem: Dict,
                          touched: Sequence[str]) -> Dict[str, np.ndarray]:
    """Destination ids of added/removed product edges per touched metapath
    (the extractor-memo invalidation key: frontier expansion only indexes
    in-neighborhoods by destination, so the source side never matters)."""
    changed: Dict[str, np.ndarray] = {}
    for mp in touched:
        a, b = old_sem[mp], new_sem[mp]
        m = max(a.num_dst, b.num_dst)
        ka = a.src.astype(np.int64) * m + a.dst.astype(np.int64)
        kb = b.src.astype(np.int64) * m + b.dst.astype(np.int64)
        diff = np.setxor1d(ka, kb, assume_unique=True)
        changed[mp] = np.unique(diff % m)
    return changed


@dataclasses.dataclass(frozen=True)
class SessionStats:
    """One snapshot of everything a session reuses.

    ``frontend_runs`` counts pipeline passes that executed;
    ``frontend_served`` counts requests answered from the session's memo.
    Cache counters are cumulative for the session's ``SemanticGraphCache``.
    ``shard`` is ``None`` on unsharded sessions; on sharded ones it sums
    every memoized plan's per-rank loads, with their max-over-mean
    ``load_balance``.
    """

    compiles: int
    compiles_cached: int
    frontend_runs: int
    frontend_served: int
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    cache_entries: int
    cache_nbytes: int
    shard: Optional[Dict] = None

    @property
    def hit_rate(self) -> float:
        """Cache hits over total lookups."""
        return self.cache_hits / max(1, self.cache_hits + self.cache_misses)

    def __getitem__(self, key: str):
        """Dict-style field access (``stats()["compiles"]``)."""
        if key.startswith("_") or not hasattr(self, key):
            raise KeyError(key)
        return getattr(self, key)


class CompiledHGNN:
    """A model bound to its frontend products and device — no knobs left.

    Entry points run eagerly.  Where the reference counts ``jax.jit``
    traces (:attr:`subset_traces`, :attr:`dependency_traces`), the port
    counts the distinct bucket signatures first seen: the shapes a trace,
    or a captured forward, would be keyed by.  On a sharded compile
    ``shard_plan`` is the plan and ``forward`` runs the
    ``ShardedHGNNExecutor`` over the compile's ranks; the subset forwards
    run the single-device banded path, as the reference's do.
    """

    def __init__(self, session: "Session", spec: ExecutorSpec, model: HGNN,
                 frontend: FrontendResult, graphs: List, fingerprint: str,
                 shard_plan: Optional[ShardPlan] = None,
                 devices: Optional[List[torch.device]] = None,
                 devkey: Optional[Tuple] = None):
        self.session = session
        self.spec = spec
        self.model = model
        self.frontend = frontend
        self.graphs = graphs
        self.fingerprint = fingerprint
        # sharded compiles: the plan (built by Session.compile, memoized),
        # the ranks and their compile-cache key; the executor builds its
        # streams on first forward
        self.shard_plan = shard_plan
        self._devices = devices
        self._devkey = devkey
        self._shard_exec: Optional[ShardedHGNNExecutor] = None
        self._extractor: Optional[DependencyExtractor] = None
        self._subset_buckets: set = set()
        self._dependency_signatures: set = set()
        # frozen SF betas per (params, features) object pair, the
        # dependency path's calibration (strong refs keep the id()-based
        # keys valid for the life of each entry)
        self._beta_memo: "OrderedDict[Tuple[int, int], Tuple]" = OrderedDict()
        # guards every lazy build (the extractor, the betas memo, the
        # signature sets): the serving engine calls in from its thread
        self._build_lock = threading.Lock()

    @property
    def cfg(self) -> HGNNConfig:
        """The bound model's ``HGNNConfig``."""
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        """The device the model runs on."""
        return torch.device(self.spec.device)

    @property
    def semantic(self) -> Dict:
        """The frontend's semantic graphs (label builders consume these)."""
        return self.frontend.semantic

    @property
    def num_target(self) -> int:
        """Vertex count of the classification target type."""
        return self.model.num_vertices[self.cfg.target_type]

    def init(self, seed: int = 0) -> Dict:
        """Parameter dict on the session's device from an integer seed."""
        return self.model.init(int(seed), device=self.device)

    def forward(self, params: Dict, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits for every ``cfg.target_type`` vertex, under
        ``torch.inference_mode()``.

        Example::

            logits = compiled.forward(params, device_features(graph, "cuda"))
            assert logits.shape == (compiled.num_target, cfg.num_classes)

        On a sharded compile the logits lie on the group's lead rank.
        """
        if self.shard_plan is not None:
            if self._shard_exec is None:
                with self._build_lock:
                    if self._shard_exec is None:
                        self._shard_exec = ShardedHGNNExecutor(
                            self.model, self.graphs, self.shard_plan,
                            devices=self._devices)
            return self._shard_exec.forward(params, features)
        with torch.inference_mode():
            return self.model.execute(params, features, self.graphs,
                                      na_executor=self.spec.na_executor)

    @property
    def shard_traces(self) -> int:
        """How many times the sharded forward built its per-rank streams:
        1 after any number of forwards on a sharded compile (0 before the
        first, and on an unsharded one)."""
        return self._shard_exec.traces if self._shard_exec is not None else 0

    @property
    def subset_traces(self) -> int:
        """Distinct id buckets :meth:`forward_subset` (head mode) has
        served — flat across resubmissions that land in one bucket::

            before = compiled.subset_traces
            compiled.forward_subset(params, feats, ids_a)
            compiled.forward_subset(params, feats, ids_b)  # same bucket
            assert compiled.subset_traces == before + 1
        """
        return len(self._subset_buckets)

    @property
    def dependency_traces(self) -> int:
        """Distinct ``DependencySubset.signature`` values the dependency
        forward has served — flat across requests whose closures share a
        bucket signature (the dependency-mode sibling of
        :attr:`subset_traces`)."""
        return len(self._dependency_signatures)

    def dependency_subset(self, node_ids, *, bucket_min: int = 8,
                          validate: bool = True) -> DependencySubset:
        """The k-hop dependency closure for an id set (memoized).

        Runs the host-side extractor (``core.subgraph``) over the
        frontend's cached semantic graphs — ``cfg.num_layers`` hops
        backward from the requested target ids — and returns the
        ``DependencySubset`` with its arrays on the model's device.
        Resubmissions of the same id set (any order, duplicates allowed)
        return the identical object; the serving engine reads
        ``.coverage`` off it to decide dependency-vs-full before paying
        for execution.

        Example::

            sub = compiled.dependency_subset(np.array([4, 7]))
            assert sub.coverage <= 1.0
        """
        if validate:
            node_ids = canonical_node_ids(node_ids, self.num_target)
        if self._extractor is None:
            with self._build_lock:
                if self._extractor is None:
                    self._extractor = DependencyExtractor(
                        self.model, self.graphs, self.frontend.semantic,
                        flavor=self.spec.na_executor, device=self.device)
        return self._extractor.extract(node_ids, bucket_min=bucket_min)

    def _fusion_betas(self, params: Dict, features: Dict) -> List[Dict]:
        """Frozen SF betas for (params, features), memoized by object
        identity (strong refs pin the keys, 4 entries); serving
        recalibrates when ``swap_params`` installs a new params object."""
        key = (id(params), id(features))
        with self._build_lock:
            ent = self._beta_memo.get(key)
            if ent is not None and ent[0] is params and ent[1] is features:
                self._beta_memo.move_to_end(key)
                return ent[2]
            with torch.inference_mode():
                betas = self.model.fusion_betas(params, features, self.graphs,
                                                na_executor=self.spec.na_executor)
            self._beta_memo[key] = (params, features, betas)
            while len(self._beta_memo) > 4:
                self._beta_memo.popitem(last=False)
            return betas

    def forward_subset(self, params: Dict, features: Dict[str, torch.Tensor],
                       node_ids, *, bucket_min: int = 8, validate: bool = True,
                       mode: str = "head") -> torch.Tensor:
        """Logits for an explicit subset of target vertices, under
        ``torch.inference_mode()``.

        ``mode="head"`` (default): message passing runs full-graph — a
        vertex's logits depend on its whole receptive field — and only the
        requested rows are gathered, so a micro-batch of node-subset
        requests moves only those rows to the host.  Row ``i`` is bitwise
        equal to row ``node_ids[i]`` of :meth:`forward`.

        ``mode="dependency"``: message passing itself runs over the ids'
        k-hop dependency closure (:meth:`dependency_subset`), so compute
        and live tensors are bounded by the receptive field, not the
        graph.  Rows match :meth:`forward` to reassociation tolerance;
        semantic-fusion betas are frozen from one full calibration
        forward per (params, features) pair (``HGNN.fusion_betas``), which
        serving pays at the first request after a registration or
        parameter swap, never per request.

        ``node_ids`` (and, in dependency mode, every closure and edge
        array) is padded to power-of-two buckets (at least
        ``bucket_min``); :attr:`subset_traces` and
        :attr:`dependency_traces` count the distinct buckets served.
        ``validate=False`` skips the id re-validation for callers that
        already canonicalized through ``canonical_node_ids`` (the serving
        engine validates at admission).

        Example::

            rows = compiled.forward_subset(params, feats, np.array([4, 7]))
            assert rows.shape == (2, cfg.num_classes)
        """
        if mode not in ("head", "dependency"):
            raise ValueError(f"unknown forward_subset mode {mode!r} "
                             "(expected 'head' or 'dependency')")
        if validate:
            ids = canonical_node_ids(node_ids, self.num_target)
        else:
            ids = np.asarray(node_ids)
        if mode == "dependency":
            return self._forward_dependency(params, features, ids, bucket_min=bucket_min)
        n = int(ids.shape[0])
        bucket = max(int(bucket_min), 1 << max(0, n - 1).bit_length())
        with self._build_lock:
            self._subset_buckets.add(bucket)
        padded = np.zeros((bucket,), np.int64)
        padded[:n] = ids
        with torch.inference_mode():
            out = self.model.execute_subset(
                params, features, self.graphs,
                torch.from_numpy(padded).to(self.device),
                na_executor=self.spec.na_executor)
        return out[:n]

    def _forward_dependency(self, params: Dict, features: Dict, ids: np.ndarray,
                            *, bucket_min: int = 8) -> torch.Tensor:
        """The dependency-mode body of :meth:`forward_subset`: extract
        (memoized), calibrate betas (memoized), run the dependency
        executor, and restore the caller's id order."""
        sub = self.dependency_subset(ids, bucket_min=bucket_min, validate=False)
        betas = self._fusion_betas(params, features)
        with self._build_lock:
            self._dependency_signatures.add(sub.signature)
        with torch.inference_mode():
            out = self.model.execute_dependency_subset(
                params, features, self.graphs, sub.arrays, betas,
                na_executor=self.spec.na_executor)
            out = out[: sub.num_ids]
            ids_arr = np.asarray(ids)
            if ids_arr.size == sub.num_ids and np.array_equal(ids_arr, sub.node_ids):
                return out  # already sorted-unique (the serving union path)
            order = np.searchsorted(sub.node_ids, ids_arr)
            return out[torch.from_numpy(order).to(out.device)]

    def _all_rows(self) -> torch.Tensor:
        return torch.ones((self.num_target,), dtype=torch.float32, device=self.device)

    def loss(self, params: Dict, features: Dict[str, torch.Tensor],
             labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked cross-entropy on the target type, a 0-d tensor that
        autograd can differentiate (not under inference mode).
        ``mask=None`` counts every vertex."""
        if mask is None:
            mask = self._all_rows()
        return self.model.execute_loss(params, features, self.graphs, labels,
                                       mask=mask, na_executor=self.spec.na_executor)

    def evaluate(self, params: Dict, features: Dict[str, torch.Tensor],
                 labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked accuracy on the target type (``train.make_eval_fn``, the
        one accuracy definition training uses); ``mask=None`` counts every
        vertex."""
        from repro_torch.train.hgnn_step import make_eval_fn

        if mask is None:
            mask = self._all_rows()
        return make_eval_fn(self.model, self.graphs,
                            na_executor=self.spec.na_executor)(
            params, features, labels, mask)

    def fit(self, features: Dict[str, torch.Tensor], labels: torch.Tensor,
            masks: Dict[str, torch.Tensor], *, epochs: int = 100, seed: int = 0,
            lr: float = 3e-3, weight_decay: float = 0.0, epoch_callback=None,
            ckpt_dir: Optional[str] = None, ckpt_every: int = 1) -> Dict:
        """Full-graph semi-supervised training on the bound executor and
        device (``train.hgnn_step.fit``: AdamW, the NA kernels' VJPs on the
        banded path).  ``ckpt_dir`` saves the train state atomically every
        ``ckpt_every`` epochs, and a re-run over the same directory resumes
        from the newest complete checkpoint.

        Example::

            out = compiled.fit(feats, labels, masks, epochs=50,
                               ckpt_dir="ckpts/acm", ckpt_every=10)
            out["losses"], out["val_acc"], out["state"].params
        """
        from repro_torch.train.hgnn_step import fit as _fit

        return _fit(self.model, self.graphs, features, labels, masks,
                    epochs=epochs, seed=seed, lr=lr, weight_decay=weight_decay,
                    na_executor=self.spec.na_executor, epoch_callback=epoch_callback,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


class Session:
    """One compile-and-run surface over one spec + one cache.

    On a CUDA spec the session turns TF32 off for matmuls and cuDNN, so
    float32 products stay float32, and it raises when no CUDA device is
    available rather than running on the CPU.  Pass a ``cache`` to share
    frontend products with another session.

    ``max_memo`` bounds each of the session's frontend, compile and
    shard-plan memos (LRU, like the cache's ``max_entries``); the default
    keeps everything for the session's lifetime.  Eviction only drops the
    session's reference: a ``CompiledHGNN`` already handed out keeps
    working.
    """

    def __init__(self, spec: Optional[ExecutorSpec] = None,
                 cache: Optional[SemanticGraphCache] = None,
                 max_memo: Optional[int] = None):
        self.spec = spec or ExecutorSpec()
        if torch.device(self.spec.device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"ExecutorSpec.device={self.spec.device!r} but no CUDA "
                    "device is available (pass device='cpu' to run the "
                    "plain versions)")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cache = cache if cache is not None else SemanticGraphCache()
        self.max_memo = max_memo
        self.pipeline = FrontendPipeline(self.spec.pipeline_config(),
                                         cache=self.cache)
        self._frontends: "OrderedDict[Tuple[str, Tuple[str, ...]], FrontendResult]" = OrderedDict()
        self._compiled: "OrderedDict[Tuple, CompiledHGNN]" = OrderedDict()
        self._shard_plans: "OrderedDict[Tuple, ShardPlan]" = OrderedDict()
        self._frontend_runs = 0
        self._frontend_served = 0
        self._compiles = 0
        self._compiles_cached = 0

    # ------------------------------------------------------------ sharding --
    def _resolve_devices(self, devices) -> Tuple[Optional[List[torch.device]], Optional[Tuple]]:
        """The ranks of a sharded compile and their compile-cache key
        (``(None, None)`` if the spec is unsharded).

        ``devices`` may hold ``torch.device``s or integer indices into
        ``device_pool(spec.device)`` (the serving engine pins tenants by
        index); ``None`` takes the whole pool, truncated to
        ``spec.mesh_shape``'s size when the spec fixes one.
        """
        if self.spec.shard == "none":
            return None, None
        pool = device_pool(self.spec.device)
        if devices is None:
            n = len(pool)
            if self.spec.mesh_shape is not None:
                n = int(np.prod(self.spec.mesh_shape))
                if n > len(pool):
                    raise ValueError(
                        f"mesh_shape {self.spec.mesh_shape} needs {n} "
                        f"devices, the pool has {len(pool)}")
            return pool[:n], tuple(range(n))
        devs, key = [], []
        for d in devices:
            if isinstance(d, (int, np.integer)):
                devs.append(pool[int(d)])
                key.append(int(d))
            else:
                devs.append(torch.device(d))
                key.append(str(devs[-1]))
        return devs, tuple(key)

    def _shard_plan_for(self, fp: str, tkey: Tuple[str, ...], graphs: List,
                        num_devices: int, feature_dim: int) -> ShardPlan:
        """The shard plan for a fingerprinted set of banded batches over
        ``num_devices`` ranks, built once and then served from the memo."""
        pkey = (fp, tkey, self.spec.shard, num_devices, feature_dim)
        plan = self._shard_plans.get(pkey)
        if plan is None:
            plan = build_shard_plan(graphs, num_devices, self.spec.shard,
                                    feature_dim=feature_dim)
            self._memo_put(self._shard_plans, pkey, plan)
        else:
            self._shard_plans.move_to_end(pkey)
        return plan

    def _memo_put(self, memo: OrderedDict, key, value) -> None:
        memo[key] = value
        memo.move_to_end(key)
        if self.max_memo is not None:
            while len(memo) > self.max_memo:
                memo.popitem(last=False)

    def frontend(self, graph: HetGraph, targets: Sequence[str]) -> FrontendResult:
        """The frontend pass for ``(graph, targets)`` — run once per
        session, then served from the session memo."""
        key = (graph.fingerprint(), tuple(sorted(targets)))
        res = self._frontends.get(key)
        if res is None:
            res = self.pipeline.run(graph, targets)
            self._memo_put(self._frontends, key, res)
            self._frontend_runs += 1
        else:
            self._frontends.move_to_end(key)
            self._frontend_served += 1
        return res

    def compile(self, graph: HetGraph, targets: Sequence[str],
                cfg: HGNNConfig, *, devices=None) -> CompiledHGNN:
        """Bind a model to the cached frontend products for this graph.

        Compiling more models over the same ``(graph, targets)`` reuses
        every frontend product; an identical ``(graph, targets, cfg,
        devices)`` compile returns the same object.

        On a sharded spec the shard plan is built here (memoized by graph
        fingerprint, targets, mode, rank count and hidden width, so every
        model over the same products shares it), and ``devices``
        optionally pins the compile to a group of ranks (``torch.device``s
        or indices into ``device_pool(spec.device)``): the serving
        engine's per-tenant pinning.  ``devices`` is rejected on an
        unsharded spec.
        """
        if devices is not None and self.spec.shard == "none":
            raise ValueError(
                "devices= requires a sharded spec (ExecutorSpec.shard is "
                "'none'): an unsharded compile has no mesh to pin")
        fp = graph.fingerprint()
        devs, devkey = self._resolve_devices(devices)
        ckey = (fp, tuple(sorted(targets)), cfg, devkey)
        self._compiles += 1
        hit = self._compiled.get(ckey)
        if hit is not None:
            self._compiled.move_to_end(ckey)
            self._compiles_cached += 1
            return hit
        res = self.frontend(graph, targets)
        if self.spec.na_executor == "banded":
            graphs = res.banded_batches(self.spec.device)
        else:
            graphs = res.batches(self.spec.device)
        model = HGNN(cfg, graph.feature_dims, graph.num_vertices, sorted(targets))
        plan = None
        if devs is not None:
            plan = self._shard_plan_for(fp, ckey[1], graphs, len(devs), cfg.hidden)
        compiled = CompiledHGNN(self, self.spec, model, res, graphs, fp,
                                shard_plan=plan, devices=devs, devkey=devkey)
        self._memo_put(self._compiled, ckey, compiled)
        return compiled

    def compile_delta(self, compiled: CompiledHGNN, graph: HetGraph,
                      delta: GraphDelta
                      ) -> Tuple[CompiledHGNN, HetGraph, DeltaResult]:
        """Re-bind a compiled model to a delta-mutated graph incrementally.

        Runs the frontend's delta path (``FrontendPipeline.apply_delta``:
        cache migration, incremental SGB on the host, block-splice repack)
        instead of a cold rebuild, then builds the successor
        ``CompiledHGNN`` on the spec's device — equal in every product to
        ``compile(graph.apply_delta(delta), ...)`` on a cold cache, but
        carrying forward what a delta cannot invalidate:

          * the dependency forward's signature set (the successor shares the
            predecessor's set object, so requests whose closures keep their
            bucket signature add nothing to :attr:`CompiledHGNN.
            dependency_traces`);
          * extractor memo entries whose closures no changed product edge
            lands on (``DependencyExtractor.migrate_from``);
          * on a sharded compile, its ranks: the successor replans (memoized
            by the new fingerprint) over the predecessor's device group.

        Untouched metapaths keep their ``PackedEdges`` objects, device
        copies included; spliced ones are new objects whose row views the
        NA kernels build on first use.  The head-mode buckets and the
        fusion betas are *not* carried — they close over the topology.
        Returns ``(new_compiled, new_graph, delta_result)``.

        Example::

            c2, g2, dres = sess.compile_delta(c1, g1, delta)
            assert c2.dependency_traces == c1.dependency_traces
        """
        if graph.fingerprint() != compiled.fingerprint:
            raise ValueError(
                "graph does not match the compiled model's fingerprint "
                "(pass the graph the model was compiled for)")
        targets = [g.metapath for g in compiled.graphs]
        dres = self.pipeline.apply_delta(graph, delta, targets)
        new_graph, res = dres.graph, dres.result
        fp_new = new_graph.fingerprint()
        tkey = tuple(sorted(targets))
        self._memo_put(self._frontends, (fp_new, tkey), res)
        self._frontend_runs += 1
        if self.spec.na_executor == "banded":
            graphs = res.banded_batches(self.spec.device)
        else:
            graphs = res.batches(self.spec.device)
        cfg = compiled.cfg
        model = HGNN(cfg, new_graph.feature_dims, new_graph.num_vertices,
                     sorted(targets))
        devs = compiled._devices
        plan = None
        if devs is not None:
            plan = self._shard_plan_for(fp_new, tkey, graphs, len(devs), cfg.hidden)
        successor = CompiledHGNN(self, self.spec, model, res, graphs, fp_new,
                                 shard_plan=plan, devices=devs, devkey=compiled._devkey)
        successor._dependency_signatures = compiled._dependency_signatures
        if compiled._extractor is not None:
            ext = DependencyExtractor(model, graphs, res.semantic,
                                      flavor=self.spec.na_executor,
                                      device=successor.device)
            changed = _changed_product_dsts(
                compiled.frontend.semantic, res.semantic, dres.touched)
            ext.migrate_from(compiled._extractor, changed,
                             frozenset(dres.touched))
            successor._extractor = ext
        self._compiles += 1
        self._memo_put(self._compiled, (fp_new, tkey, cfg, compiled._devkey),
                       successor)
        return successor, new_graph, dres

    def stats(self) -> SessionStats:
        """Snapshot of the session's reuse counters.

        Example::

            sess.compile(g, targets, cfg); sess.compile(g, targets, cfg)
            assert sess.stats().compiles_cached == 1
        """
        cs = self.cache.stats
        return SessionStats(
            compiles=self._compiles,
            compiles_cached=self._compiles_cached,
            frontend_runs=self._frontend_runs,
            frontend_served=self._frontend_served,
            cache_hits=cs.hits,
            cache_misses=cs.misses,
            cache_evictions=cs.evictions,
            cache_entries=len(self.cache),
            cache_nbytes=self.cache.nbytes(),
            shard=self._shard_stats(),
        )

    def _shard_stats(self) -> Optional[Dict]:
        """Per-rank edge-block, edge and MAC counts summed over every
        memoized shard plan, and their max-over-mean edge load (``None``
        when the spec is unsharded)."""
        if self.spec.shard == "none":
            return None
        plans = list(self._shard_plans.values())
        ndev = max((p.num_devices for p in plans), default=0)
        blocks = np.zeros(ndev, np.int64)
        edges = np.zeros(ndev, np.int64)
        macs = np.zeros(ndev, np.int64)
        for p in plans:
            blocks[: p.num_devices] += p.device_block_counts()
            edges[: p.num_devices] += p.device_edge_counts()
            macs[: p.num_devices] += p.device_mac_counts()
        total = int(edges.sum())
        lb = float(edges.max() / (total / ndev)) if total else 1.0
        return {
            "mode": self.spec.shard,
            "plans": len(plans),
            "per_device_edge_blocks": blocks.tolist(),
            "per_device_edges": edges.tolist(),
            "per_device_macs": macs.tolist(),
            "load_balance": lb,
        }
