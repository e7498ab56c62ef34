"""The port's side of the HGNN cells: the graph handed to the port, its
compiled model, the sizes of its packings, and the comparison of its
semantic graphs with the reference's."""
from __future__ import annotations

from typing import Dict, List

import torch


def compile_model(config: Dict, inp, device: str):
    """``Session(ExecutorSpec(...)).compile`` of the configuration's model
    over the cell's graph, on a cold session."""
    from repro_torch.api import ExecutorSpec, Session
    from repro_torch.core.hgnn.models import HGNNConfig
    from repro_torch.hetero.graph import HetGraph, Relation

    model = config["model"]
    nv = inp.num_vertices
    rels = {name: Relation(name[0], name[1], nv[name[0]], nv[name[1]], s, d)
            for name, (s, d) in inp.relations.items()}
    graph = HetGraph(name=config["graph"]["dataset"], num_vertices=dict(nv),
                     feature_dims=dict(inp.feature_dims), relations=rels)
    sess = Session(ExecutorSpec(device=device, **config["spec"]))
    hcfg = HGNNConfig(**{k: model[k] for k in ("model", "hidden", "num_layers", "num_classes",
                                                "target_type", "edge_emb_dim", "sf_att_dim")})
    return sess.compile(graph, sorted(config["metapaths"]), hcfg)


def graph_sizes(compiled) -> List[Dict]:
    """Each banded graph's packing sizes, for the launch bounds and FLOPs."""
    return [{"edges": int(g.packed.num_edges), "blocks": int(g.packed.num_blocks),
             "tiles": int(g.packed.num_dst_tiles), "num_src": int(g.num_src),
             "num_dst": int(g.num_dst), "dst_type": g.dst_type} for g in compiled.graphs]


def semantic_edges(compiled) -> Dict:
    """The program's semantic graphs as ``{metapath: (src, dst)}`` arrays."""
    return {mp: (r.src, r.dst) for mp, r in compiled.semantic.items()}


def sgb_edges_diff(program_semantic: Dict, reference_semantic, n: int) -> int:
    """Edges in one side's semantic graphs and not the other's, summed
    over the metapaths (``n`` bounds every destination id)."""
    diff = 0
    for mp, src, dst in reference_semantic:
        ps, pd = program_semantic[mp]
        a = torch.unique(src.long() * n + dst.long())
        b = torch.unique(torch.as_tensor(ps, device=src.device).long() * n
                         + torch.as_tensor(pd, device=src.device).long())
        diff += int(a.numel() + b.numel() - 2 * torch.isin(a, b).sum())
    return diff
