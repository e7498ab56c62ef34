"""Execution sessions: one compile-and-run surface for the port.

A ``Session`` owns a ``FrontendPipeline`` + ``SemanticGraphCache``
configured from one ``ExecutorSpec``::

    sess = Session(ExecutorSpec(na_executor="banded"))       # device="cuda"
    compiled = sess.compile(graph, targets, HGNNConfig(model="rgat"))
    params = compiled.init(0)
    logits = compiled.forward(params, device_features(graph, "cuda"))
    out = compiled.fit(feats, labels, masks, epochs=20)   # training

``na_executor="jnp"`` runs NA as plain segment sums over global edge
lists instead of the kernels.

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.api.spec import ExecutorSpec
from repro_torch.core.hgnn.models import HGNN, HGNNConfig
from repro_torch.hetero.graph import HetGraph
from repro_torch.pipeline.cache import SemanticGraphCache
from repro_torch.pipeline.frontend import FrontendPipeline, FrontendResult


def device_features(graph: HetGraph, device) -> Dict[str, torch.Tensor]:
    """Copy a HetGraph's raw feature dict to ``device`` (the form every
    compiled entry point takes).

    Example::

        feats = device_features(graph, "cuda")   # {"P": (N_P, d_P), ...}
        logits = compiled.forward(params, feats)
    """
    return {t: torch.from_numpy(x).to(device) for t, x in graph.features.items()}


@dataclasses.dataclass(frozen=True)
class SessionStats:
    """One snapshot of everything a session reuses.

    ``frontend_runs`` counts pipeline passes that executed;
    ``frontend_served`` counts requests answered from the session's memo.
    Cache counters are cumulative for the session's ``SemanticGraphCache``.
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
    """A model bound to its frontend products and device — no knobs left."""

    def __init__(self, session: "Session", spec: ExecutorSpec, model: HGNN,
                 frontend: FrontendResult, graphs: List, fingerprint: str):
        self.session = session
        self.spec = spec
        self.model = model
        self.frontend = frontend
        self.graphs = graphs
        self.fingerprint = fingerprint

    @property
    def cfg(self) -> HGNNConfig:
        """The bound model's ``HGNNConfig``."""
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        """The device the model runs on."""
        return torch.device(self.spec.device)

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
        """
        with torch.inference_mode():
            return self.model.execute(params, features, self.graphs,
                                      na_executor=self.spec.na_executor)

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
    """

    def __init__(self, spec: Optional[ExecutorSpec] = None,
                 cache: Optional[SemanticGraphCache] = None):
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
        self.pipeline = FrontendPipeline(self.spec.pipeline_config(),
                                         cache=self.cache)
        self._frontends: Dict[Tuple[str, Tuple[str, ...]], FrontendResult] = {}
        self._compiled: Dict[Tuple, CompiledHGNN] = {}
        self._frontend_runs = 0
        self._frontend_served = 0
        self._compiles = 0
        self._compiles_cached = 0

    def frontend(self, graph: HetGraph, targets: Sequence[str]) -> FrontendResult:
        """The frontend pass for ``(graph, targets)`` — run once per
        session, then served from the session memo."""
        key = (graph.fingerprint(), tuple(sorted(targets)))
        res = self._frontends.get(key)
        if res is None:
            res = self.pipeline.run(graph, targets)
            self._frontends[key] = res
            self._frontend_runs += 1
        else:
            self._frontend_served += 1
        return res

    def compile(self, graph: HetGraph, targets: Sequence[str],
                cfg: HGNNConfig) -> CompiledHGNN:
        """Bind a model to the cached frontend products for this graph.

        Compiling more models over the same ``(graph, targets)`` reuses
        every frontend product; an identical ``(graph, targets, cfg)``
        compile returns the same object.
        """
        fp = graph.fingerprint()
        ckey = (fp, tuple(sorted(targets)), cfg)
        self._compiles += 1
        hit = self._compiled.get(ckey)
        if hit is not None:
            self._compiles_cached += 1
            return hit
        res = self.frontend(graph, targets)
        if self.spec.na_executor == "banded":
            graphs = res.banded_batches(self.spec.device)
        else:
            graphs = res.batches(self.spec.device)
        model = HGNN(cfg, graph.feature_dims, graph.num_vertices, sorted(targets))
        compiled = CompiledHGNN(self, self.spec, model, res, graphs, fp)
        self._compiled[ckey] = compiled
        return compiled

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
        )
