"""Inputs of the HGNN cells, made by the benchmark from the seed and
handed to the port and to the reference alike.

The graph's topology is the configuration's (the frozen Table 2
generator at the configuration's ``graph_seed`` and ``scale``); the run's
seed renumbers every vertex type by a seeded permutation, so every seed
gives the same sizes, degrees and semantic-graph edge counts in another
order.  Features and the model's parameters are drawn on the device from
the seed; the train / validation / test split is the port's
``semi_supervised_masks`` rule (numpy-seeded), copied here; labels are
quantile buckets of the summed semantic in-degree, over the reference's
own composition of the metapaths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from gbench import datagen
from reference import hgnn_ref


@dataclasses.dataclass
class HGNNInputs:
    num_vertices: Dict[str, int]
    feature_dims: Dict[str, int]
    relations: Dict[str, Tuple[np.ndarray, np.ndarray]]  # canonical one-hop edges
    features: Dict[str, torch.Tensor]
    params: Dict
    masks: Dict[str, torch.Tensor]
    labels: torch.Tensor  # int64
    semantic: List[Tuple[str, torch.Tensor, torch.Tensor]]  # the reference's composition


def permuted_relations(graph: dict, seed: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``graph``'s relations with every vertex type renumbered by a
    permutation drawn from ``seed``, in canonical order."""
    rng = np.random.default_rng(seed)
    perm = {t: rng.permutation(n).astype(np.int64)
            for t, n in sorted(graph["num_vertices"].items())}
    out = {}
    for name, (src, dst) in graph["relations"].items():
        s, d = name[0], name[1]
        out[name] = datagen.canonical(graph["num_vertices"][d], perm[s][src], perm[d][dst])
    return out


def semi_supervised_masks(num_nodes: int, seed: int, train_frac: float, val_frac: float,
                          device) -> Dict[str, torch.Tensor]:
    """Random train / validation / test split as float32 masks (the port's
    rule: one numpy permutation from ``seed``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_train = int(round(num_nodes * train_frac))
    n_held = n_train + int(round(num_nodes * val_frac))
    out = {}
    for name, ids in (("train", perm[:n_train]), ("val", perm[n_train:n_held]),
                      ("test", perm[n_held:])):
        m = np.zeros(num_nodes, np.float32)
        m[ids] = 1.0
        out[name] = torch.from_numpy(m).to(device)
    return out


def shgn_params(seed: int, model: dict, feature_dims: Dict[str, int],
                metapaths: List[str], device) -> Dict:
    """Simple-HGN parameters with the port's keys and shapes, drawn on
    ``device`` from ``seed``: dense weights normal times ``sqrt(2 /
    fan_in)``, attention vectors normal times 0.1, biases zero."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h, att, emb = model["hidden"], model["sf_att_dim"], model["edge_emb_dim"]

    def normal(*shape, scale):
        return torch.randn(*shape, generator=gen, device=device) * scale

    def dense(d_in, d_out):
        return normal(d_in, d_out, scale=(2.0 / max(1, d_in)) ** 0.5)

    def zeros(n):
        return torch.zeros(n, device=device)

    types = sorted(feature_dims)
    layers = []
    for layer in range(model["num_layers"]):
        lp: Dict = {"fp": {}, "na": {}, "sf": {}}
        for t in types:
            d_in = feature_dims[t] if layer == 0 else h
            lp["fp"][t] = {"w": dense(d_in or 1, h), "b": zeros(h)}
        for mp in metapaths:
            lp["na"][mp] = {"w_rel": dense(h, h), "a_src": normal(h, scale=0.1),
                            "a_dst": normal(h, scale=0.1)}
        lp["edge_emb"] = normal(len(metapaths), emb, scale=0.1)
        lp["a_edge"] = normal(emb, scale=0.1)
        for t in types:
            lp["sf"][t] = {"w": dense(h, att), "b": zeros(att), "q": normal(att, scale=0.1),
                           "w_self": dense(h, h)}
        layers.append(lp)
    return {"layers": layers, "head": {"w": dense(h, model["num_classes"]),
                                       "b": zeros(model["num_classes"])}}


def make(config: dict, seed: int, device) -> HGNNInputs:
    """Every input of an HGNN cell of ``config`` (a configuration file's
    dict) for ``seed`` on ``device``."""
    gcfg, model = config["graph"], config["model"]
    graph = datagen.make_graph(gcfg["dataset"], seed=gcfg["graph_seed"],
                               scale=gcfg["scale"], features=False)
    nv = graph["num_vertices"]
    rels = permuted_relations(graph, seed)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    feats = {t: torch.randn((nv[t], d), generator=gen, device=device) * gcfg["feature_scale"]
             for t, d in sorted(graph["feature_dims"].items()) if d > 0}
    metapaths = sorted(config["metapaths"])
    params = shgn_params(seed, model, graph["feature_dims"], metapaths, device)
    split = config["split"]
    target = model["target_type"]
    masks = semi_supervised_masks(nv[target], seed, split["train"], split["val"], device)
    semantic = [(mp, *hgnn_ref.compose(rels, nv, mp, device)) for mp in metapaths]
    labels = hgnn_ref.degree_bucket_labels([(s, d) for _, s, d in semantic], nv[target],
                                           model["num_classes"])
    return HGNNInputs(nv, dict(graph["feature_dims"]), rels, feats, params, masks,
                      labels, semantic)
