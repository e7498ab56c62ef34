"""RGCN / RGAT / Simple-HGN on semantic graphs — the paper's GFP workload.

Per layer: FP (a dense projection per vertex type), NA per semantic graph
(mean for RGCN, edge-softmax attention for RGAT and Simple-HGN with an
edge-type term), then SF (HAN-style semantic attention over every
semantic graph ending at a type, plus a self path).  NA runs on one of two
executors, as in the JAX package: ``"banded"`` (the NA kernels over the
restructurer's packings, ``BandedBatch`` inputs) or ``"jnp"`` (plain
segment sums over global edge lists, ``SemanticGraphBatch`` inputs).
Parameters are an explicit nested dict of tensors with the JAX package's
exact keys, so ``params_from_numpy`` carries its weights across.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.hgnn.layers import (feature_projection, na_attention,
                                          na_attention_banded, na_mean,
                                          na_mean_banded, semantic_fusion_beta)
from repro_torch.hetero.graph import HetGraph, Relation
from repro_torch.kernels.seg_sum import PackedEdges

NA_EXECUTORS = ("jnp", "banded")


def _idx(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


@dataclasses.dataclass(frozen=True)
class SemanticGraphBatch:
    """Device-ready semantic graph for the segment-sum executor: global
    ``(src, dst)`` edge index tensors (int64) on one device."""

    metapath: str
    src_type: str
    dst_type: str
    num_src: int
    num_dst: int
    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    edge_type_id: int  # index into the Simple-HGN edge-type embedding

    @staticmethod
    def from_relation(rel: Relation, metapath: str, edge_type_id: int,
                      device="cuda", order: Optional[np.ndarray] = None
                      ) -> "SemanticGraphBatch":
        """Build from a ``Relation``'s own (src, dst)-sorted edges, or from
        them taken in ``order`` (an edge permutation) when one is given."""
        src, dst = rel.src, rel.dst
        if order is not None:
            src, dst = src[order], dst[order]
        return SemanticGraphBatch.from_edge_stream(
            metapath, rel.num_src, rel.num_dst, src, dst, edge_type_id, device)

    @staticmethod
    def from_edge_stream(metapath: str, num_src: int, num_dst: int,
                         src: np.ndarray, dst: np.ndarray, edge_type_id: int,
                         device) -> "SemanticGraphBatch":
        """Build from an explicit (already scheduled) edge stream — the
        restructured layout path."""
        return SemanticGraphBatch(
            metapath=metapath,
            src_type=metapath[0],
            dst_type=metapath[-1],
            num_src=num_src,
            num_dst=num_dst,
            src=_idx(src, device),
            dst=_idx(dst, device),
            edge_type_id=edge_type_id,
        )


@dataclasses.dataclass(frozen=True)
class BandedBatch:
    """Device-ready semantic graph in the restructured banded layout.

    Carries the pipeline's cached ``PackedEdges`` blocks plus the
    permutations that move per-layer features into the renumbered banded
    numbering and NA outputs back to global vertex order.  FP and SF stay
    in global numbering; only NA runs banded.
    """

    metapath: str
    src_type: str
    dst_type: str
    num_src: int
    num_dst: int
    edge_type_id: int
    packed: PackedEdges  # renumbered banded blocks (host-built, cached)
    src_gather: torch.Tensor  # (num_src,) banded row -> global src id
    dst_gather: torch.Tensor  # (num_dst,) banded row -> global dst id
    dst_scatter: torch.Tensor  # (num_dst,) global dst -> banded row
    src_banded: torch.Tensor  # (E,) banded src ids, scheduled order
    dst_banded: torch.Tensor  # (E,) banded dst ids, scheduled order
    deg: torch.Tensor  # (num_dst,) in-degree per banded dst row (float32)

    @staticmethod
    def from_restructured(metapath: str, rg, packed: PackedEdges,
                          edge_type_id: int, device) -> "BandedBatch":
        """Build from a ``RestructuredGraph`` and its renumbered packing
        (``rg.packed(renumbered=True)``), with tensors on ``device``."""
        rel = rg.original
        sperm, dperm = rg.permutations()  # global -> banded
        s, d = rg.scheduled_edges(renumbered=True)
        deg = np.bincount(d, minlength=rel.num_dst).astype(np.float32)

        def up(a):
            return _idx(a, device)

        return BandedBatch(
            metapath=metapath,
            src_type=metapath[0],
            dst_type=metapath[-1],
            num_src=rel.num_src,
            num_dst=rel.num_dst,
            edge_type_id=edge_type_id,
            packed=packed,
            src_gather=up(np.argsort(sperm)),
            dst_gather=up(np.argsort(dperm)),
            dst_scatter=up(dperm),
            src_banded=up(s),
            dst_banded=up(d),
            deg=torch.from_numpy(deg).to(device),
        )


@dataclasses.dataclass(frozen=True)
class HGNNConfig:
    """Model family and widths (paper §5.3: hidden 64, 3 layers)."""

    model: str  # "rgcn" | "rgat" | "shgn"
    hidden: int = 64
    num_layers: int = 3
    num_classes: int = 3
    target_type: str = "P"
    edge_emb_dim: int = 16  # Simple-HGN edge-type embedding
    sf_att_dim: int = 64

    def __post_init__(self):
        if self.model not in ("rgcn", "rgat", "shgn"):
            raise ValueError(f"unknown model {self.model!r}")


def init_params(
    seed: int,
    cfg: HGNNConfig,
    feature_dims: Dict[str, int],
    metapaths: List[str],
    hidden_override: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Build the parameter dict from a ``torch.Generator`` seeded with ``seed``.

    Same keys, shapes and scales as the JAX package's ``init_params``
    (normal draws times ``sqrt(2 / fan_in)`` for dense weights, times 0.1
    for attention vectors, zero biases); the values differ from
    ``jax.random``'s.  Draws happen on the CPU, so a seed gives the same
    parameters on every device.  ``hidden_override`` replaces
    ``cfg.hidden`` as the width when given.
    """
    gen = torch.Generator().manual_seed(int(seed))
    h = hidden_override or cfg.hidden

    def normal(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def dense(d_in, d_out):
        return normal(d_in, d_out, scale=(2.0 / max(1, d_in)) ** 0.5)

    def zeros(n):
        return torch.zeros(n, device=device)

    params: Dict = {"layers": []}
    types = sorted(feature_dims)
    for layer in range(cfg.num_layers):
        lp: Dict = {"fp": {}, "na": {}, "sf": {}}
        for t in types:
            d_in = feature_dims[t] if layer == 0 else h
            # a featureless type (d_in == 0) gets a learned constant row
            lp["fp"][t] = {"w": dense(d_in or 1, h), "b": zeros(h)}
        for mp in metapaths:
            na: Dict = {"w_rel": dense(h, h)}
            if cfg.model in ("rgat", "shgn"):
                na["a_src"] = normal(h, scale=0.1)
                na["a_dst"] = normal(h, scale=0.1)
            lp["na"][mp] = na
        if cfg.model == "shgn":
            lp["edge_emb"] = normal(len(metapaths), cfg.edge_emb_dim, scale=0.1)
            lp["a_edge"] = normal(cfg.edge_emb_dim, scale=0.1)
        for t in types:
            lp["sf"][t] = {
                "w": dense(h, cfg.sf_att_dim),
                "b": zeros(cfg.sf_att_dim),
                "q": normal(cfg.sf_att_dim, scale=0.1),
                "w_self": dense(h, h),
            }
        params["layers"].append(lp)
    params["head"] = {"w": dense(h, cfg.num_classes), "b": zeros(cfg.num_classes)}
    return params


def params_from_numpy(tree, device) -> Dict:
    """Turn a nested dict/list of numpy arrays — the JAX package's parameter
    pytree after ``jax.tree.map(np.asarray, ...)`` — into the port's dict
    of float32 tensors on ``device``, keys unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


class HGNN:
    """Config + forward function over an explicit parameter dict."""

    def __init__(self, cfg: HGNNConfig, feature_dims: Dict[str, int],
                 num_vertices: Dict[str, int], metapaths: List[str]):
        self.cfg = cfg
        self.feature_dims = dict(feature_dims)
        self.num_vertices = dict(num_vertices)
        self.metapaths = list(metapaths)

    def init(self, seed: int, device="cuda") -> Dict:
        """Parameters from ``seed`` on ``device`` (see :func:`init_params`)."""
        return init_params(seed, self.cfg, self.feature_dims, self.metapaths,
                           device=device)

    # The FP, SF and head stages, shared by every forward (full, subsets,
    # the sharded executor), so all of them run the same operations.
    def input_states(self, features: Dict[str, torch.Tensor], device,
                     rows: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Layer-0 states per type: the features (their ``rows`` when
        given), or a ones column for a featureless type."""
        h: Dict[str, torch.Tensor] = {}
        for t, n in self.num_vertices.items():
            if rows is not None:
                n = rows[t].shape[0]
            if self.feature_dims.get(t, 0) > 0:
                h[t] = features[t] if rows is None else features[t][rows[t]]
            else:
                h[t] = torch.ones((n, 1), dtype=torch.float32, device=device)
        return h

    @staticmethod
    def project(lp: Dict, h: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """FP sub-stage of one layer: ``relu(x @ w + b)`` per type."""
        return {t: torch.relu(feature_projection(lp["fp"][t]["w"], lp["fp"][t]["b"], x))
                for t, x in h.items()}

    @staticmethod
    def fuse(lp: Dict, hp: Dict[str, torch.Tensor],
             z_by_dst: Dict[str, List[torch.Tensor]],
             betas: Optional[Dict[str, torch.Tensor]] = None,
             betas_out: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """SF sub-stage of one layer, then ReLU: per type, the semantic
        attention over its NA outputs and its self path.  ``betas`` freezes
        the attention weights (the dependency-subset executor); otherwise
        they are computed here and, when ``betas_out`` is a dict, stored
        in it by type."""
        h_next: Dict[str, torch.Tensor] = {}
        for t, x in hp.items():
            sf = lp["sf"][t]
            self_z = x @ sf["w_self"]
            if t in z_by_dst:
                stack = torch.stack(z_by_dst[t] + [self_z])  # (P+1, N, D)
                if betas is not None:
                    beta = betas[t]
                else:
                    beta = semantic_fusion_beta(stack, sf["w"], sf["b"], sf["q"])
                    if betas_out is not None:
                        betas_out[t] = beta
                h_next[t] = torch.einsum("p,pnd->nd", beta, stack)
            else:
                h_next[t] = self_z
        return {t: torch.relu(v) for t, v in h_next.items()}

    def head(self, params: Dict, h: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits of every ``cfg.target_type`` row of ``h``."""
        head = params["head"]
        with tracing.span("hgnn.head"):
            return h[self.cfg.target_type] @ head["w"] + head["b"]

    def hidden_states(
        self,
        params: Dict,
        features: Dict[str, torch.Tensor],
        graphs: List,
        *,
        na_executor: str = "banded",
        betas_out: Optional[List] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run every FP -> NA -> SF layer; returns the final per-type hidden
        states in global vertex numbering.

        ``betas_out``, when given an empty list, collects one
        ``{dst_type: (P_t + 1,)}`` dict of semantic-attention weights per
        layer — the graph-level SF statistics the dependency-subset
        executor freezes (see :meth:`fusion_betas`).

        ``na_executor`` selects the NA executor:

        * ``"banded"`` — the NA kernels over the restructurer's packings
          (``graphs`` are ``BandedBatch``); features are permuted once per
          layer into each graph's banded layout and NA outputs permuted
          back.  The device of the parameters picks the implementation:
          CUDA launches the kernels, CPU runs their plain versions.
        * ``"jnp"`` — plain segment sums over global edge lists (``graphs``
          are ``SemanticGraphBatch``), the JAX package's name for it.

        Both are differentiable (see :meth:`execute_loss`).  Each layer's
        FP and SF, and each of its NA calls, is a span (``hgnn.fp``,
        ``hgnn.sf``, ``hgnn.na`` with the layer and metapath).
        """
        cfg = self.cfg
        if na_executor not in NA_EXECUTORS:
            raise ValueError(f"unknown na_executor {na_executor!r}")
        banded = na_executor == "banded"
        for g in graphs:
            if banded != isinstance(g, BandedBatch):
                raise TypeError(
                    f"na_executor={na_executor!r} needs "
                    f"{'BandedBatch' if banded else 'SemanticGraphBatch'} "
                    f"inputs, got {type(g).__name__} for "
                    f"{getattr(g, 'metapath', '?')!r}")
        h = self.input_states(features, params["head"]["w"].device)
        for li, lp in enumerate(params["layers"]):
            with tracing.span("hgnn.fp", layer=li):
                hp = self.project(lp, h)
            z_by_dst: Dict[str, List[torch.Tensor]] = {}
            for g in graphs:
                na_p = lp["na"][g.metapath]
                h_src = hp[g.src_type] @ na_p["w_rel"]
                edge_bias = None
                if cfg.model == "shgn":
                    edge_bias = lp["edge_emb"][g.edge_type_id] @ lp["a_edge"]
                with tracing.span("hgnn.na", layer=li, metapath=g.metapath):
                    if banded:
                        hb = h_src[g.src_gather]
                        if cfg.model == "rgcn":
                            zb = na_mean_banded(g.packed, hb, g.deg)
                        else:
                            zb = na_attention_banded(
                                hb, hp[g.dst_type][g.dst_gather],
                                g.src_banded, g.dst_banded, g.packed,
                                na_p["a_src"], na_p["a_dst"], edge_bias=edge_bias,
                            )
                        z = zb[g.dst_scatter]
                    elif cfg.model == "rgcn":
                        z = na_mean(h_src, g.src, g.dst, g.num_dst)
                    else:
                        z = na_attention(h_src, hp[g.dst_type], g.src, g.dst,
                                         g.num_dst, na_p["a_src"], na_p["a_dst"],
                                         edge_bias=edge_bias)
                z_by_dst.setdefault(g.dst_type, []).append(z)
            layer_betas: Dict[str, torch.Tensor] = {}
            with tracing.span("hgnn.sf", layer=li):
                h = self.fuse(lp, hp, z_by_dst, betas_out=layer_betas)
            if betas_out is not None:
                betas_out.append(layer_betas)
        return h

    def fusion_betas(
        self,
        params: Dict,
        features: Dict[str, torch.Tensor],
        graphs: List,
        *,
        na_executor: str = "banded",
    ) -> List[Dict[str, torch.Tensor]]:
        """Per-layer SF attention weights from one full forward.

        Semantic fusion's beta is a mean over *all* rows of a type — a
        graph-level statistic with no per-request dependence — so the
        dependency-subset executor cannot re-derive it from a partial row
        set and takes these frozen values instead (recomputed only when
        parameters or features change; serving recalibrates on
        ``swap_params``).  Returns ``cfg.num_layers`` dicts keyed by
        destination type, each ``(num_graphs_into_type + 1,)``.
        """
        betas: List[Dict[str, torch.Tensor]] = []
        self.hidden_states(params, features, graphs, na_executor=na_executor,
                           betas_out=betas)
        return betas

    def execute_dependency_subset(
        self,
        params: Dict,
        features: Dict[str, torch.Tensor],
        graphs: List,
        dep: Dict,
        betas: List[Dict[str, torch.Tensor]],
        *,
        na_executor: str = "banded",
    ) -> torch.Tensor:
        """FP -> NA -> SF over an induced k-hop dependency subgraph.

        ``dep`` is a ``core.subgraph.DependencySubset.arrays`` dict for
        the same graphs and executor flavor as ``graphs``, and ``betas``
        the frozen SF weights from :meth:`fusion_betas` under the same
        parameters and features.  Rows ``dep["node_rows"][:n]`` of the
        result match the same target rows of :meth:`execute` to
        reassociation tolerance: the closure keeps every edge into the
        hop-``L-1`` frontier, so requested rows aggregate their full
        receptive field while garbage on deeper-frontier rows only flows
        into outputs nothing reads.  On the banded flavor each NA call is
        one K1 launch over the extraction's sliced packing (CUDA) or its
        plain version (CPU), after one K2 launch for rgat and shgn.
        """
        from repro_torch.core.subgraph import (na_attention_subset_banded,
                                               na_mean_subset_banded)

        cfg = self.cfg
        if na_executor not in NA_EXECUTORS:
            raise ValueError(f"unknown na_executor {na_executor!r}")
        banded = na_executor == "banded"
        gather = dep["gather"]
        h = self.input_states(features, params["head"]["w"].device, rows=gather)
        for li, lp in enumerate(params["layers"]):
            hp = self.project(lp, h)
            z_by_dst: Dict[str, List[torch.Tensor]] = {}
            for g, dg in zip(graphs, dep["graphs"]):
                na_p = lp["na"][g.metapath]
                h_src = hp[g.src_type] @ na_p["w_rel"]
                edge_bias = None
                if cfg.model == "shgn":
                    edge_bias = lp["edge_emb"][g.edge_type_id] @ lp["a_edge"]
                num_dst = gather[g.dst_type].shape[0]
                if banded:
                    if cfg.model == "rgcn":
                        z = na_mean_subset_banded(dg, h_src)
                    else:
                        z = na_attention_subset_banded(
                            dg, h_src, hp[g.dst_type], na_p["a_src"],
                            na_p["a_dst"], edge_bias=edge_bias)
                else:
                    # int32 as extracted; the segment ops scatter by int64
                    src, dst = dg["src"].long(), dg["dst"].long()
                    if cfg.model == "rgcn":
                        z = na_mean(h_src, src, dst, num_dst)
                    else:
                        z = na_attention(h_src, hp[g.dst_type], src, dst, num_dst,
                                         na_p["a_src"], na_p["a_dst"],
                                         edge_bias=edge_bias)
                z_by_dst.setdefault(g.dst_type, []).append(z)
            h = self.fuse(lp, hp, z_by_dst, betas=betas[li])
        return self.head(params, {cfg.target_type: h[cfg.target_type][dep["node_rows"]]})

    def execute(
        self,
        params: Dict,
        features: Dict[str, torch.Tensor],
        graphs: List,
        *,
        na_executor: str = "banded",
    ) -> torch.Tensor:
        """Full GFP stage; logits for every ``cfg.target_type`` vertex."""
        return self.head(params, self.hidden_states(params, features, graphs,
                                                    na_executor=na_executor))

    def execute_subset(
        self,
        params: Dict,
        features: Dict[str, torch.Tensor],
        graphs: List,
        node_ids: torch.Tensor,
        *,
        na_executor: str = "banded",
    ) -> torch.Tensor:
        """Logits for an explicit subset of ``cfg.target_type`` vertices.

        Message passing runs full-graph (a target vertex's receptive
        field spans the whole topology); the serving micro-batch path
        (``CompiledHGNN.forward_subset``) unions a queue of small
        node-subset requests into one padded ``node_ids`` tensor, so only
        those rows leave the device.  Row ``i`` equals row
        ``node_ids[i]`` of :meth:`execute` bit for bit, as the forward
        repeats bit for bit on either executor and device (the segment-sum
        executor sums each segment in a fixed order, ``layers.segment_sum``):
        the head runs over every row before the gather, because a GEMM over
        fewer rows may take another kernel and summation order (the head is
        ``N x hidden x classes``, a small share of a forward).
        """
        return self.execute(params, features, graphs,
                            na_executor=na_executor)[node_ids]

    def execute_loss(self, params: Dict, features: Dict[str, torch.Tensor],
                     graphs: List, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     na_executor: str = "banded") -> torch.Tensor:
        """Masked cross-entropy over ``cfg.target_type`` vertices
        (semi-supervised node classification), a 0-d tensor.
        Differentiable on both NA executors: on the banded one the NA
        kernels' Functions carry the reference's VJPs, so its gradients
        match the segment-sum executor's to float tolerance."""
        logits = self.execute(params, features, graphs, na_executor=na_executor)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
        if mask is not None:
            return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
        return torch.mean(nll)


def package_batches(
    semantic: Dict[str, Relation],
    targets: List[str],
    restructured: bool = False,
    restructured_graphs: Optional[Dict[str, object]] = None,
    *,
    device="cuda",
) -> List[SemanticGraphBatch]:
    """Semantic graphs -> ``SemanticGraphBatch`` list on ``device``, in
    ``sorted(targets)`` order (the edge-type ids).

    Batches carry global vertex ids; with ``restructured=True`` each edge
    stream is the restructurer's schedule (``restructured_graphs`` supplies
    already-computed ``RestructuredGraph`` objects).
    """
    from repro_torch.core.restructure import restructure

    out = []
    for i, mp in enumerate(sorted(targets)):
        rel = semantic[mp]
        if restructured:
            rg = (restructured_graphs or {}).get(mp)
            if rg is None:
                rg = restructure(rel)
            s, d = rg.scheduled_edges()
            out.append(SemanticGraphBatch.from_edge_stream(
                mp, rel.num_src, rel.num_dst, s, d, i, device))
        else:
            out.append(SemanticGraphBatch.from_relation(rel, mp, i, device))
    return out


def graphs_from_sgb(
    graph: HetGraph,
    semantic: Dict[str, Relation],
    targets: List[str],
    restructured: bool = False,
    restructured_graphs: Optional[Dict[str, object]] = None,
    *,
    device="cuda",
) -> List[SemanticGraphBatch]:
    """Package SGB outputs for the model on ``device``, optionally in the
    restructurer's schedule (see :func:`package_batches`); ``graph`` is
    unused, as packaging depends only on the semantic graphs."""
    del graph
    return package_batches(semantic, targets, restructured=restructured,
                           restructured_graphs=restructured_graphs, device=device)


def graphs_from_pipeline(result, device="cuda") -> List[SemanticGraphBatch]:
    """Segment-sum batches from a ``pipeline.FrontendResult`` on ``device``
    (built once on the result, shared by every model)."""
    return result.batches(device)


def banded_graphs_from_pipeline(result, device="cuda") -> List[BandedBatch]:
    """Banded batches from a ``pipeline.FrontendResult`` on ``device``, for
    the banded NA executor: one ``PackedEdges`` per semantic graph, shared
    by every model and layer."""
    return result.banded_batches(device)
