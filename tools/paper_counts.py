"""The paper's SGB, CTT and GFP quantities, counted by the port.

For each dataset at scale 1.0 (seed 0) and its targets:

* SGB (Figs. 14/15): compositions, join MACs and edge-list bytes
  (``CompositionCost.total_bytes``) of the naive, ctt and ctt_dp plans;
* CTT (Table 3's 5 KB buffer): ``CallbackTrieTree.nbytes()`` after the ctt
  plan's products are inserted, and the materialized metapaths;
* GFP: ``PackedEdges.hbm_feature_bytes(64)`` (fp32) of each target's
  restructured packing against a packing of its edges in (dst, src) order,
  as ``benchmarks/gfp_bench.py`` counts them.

Host numpy only (no device); the counts are exact and the same on every
machine.  Prints one line per quantity and, last, one JSON object.

  PYTHONPATH=src python tools/paper_counts.py [DATASET ...]
"""
from __future__ import annotations

import json
import sys

import numpy as np

from repro_torch.core.ctt import CallbackTrieTree
from repro_torch.core.sgb import execute_plan, make_plan
from repro_torch.hetero import make_dataset
from repro_torch.kernels.seg_sum import pack_edge_blocks
from repro_torch.pipeline import FrontendPipeline, PipelineConfig, SemanticGraphCache

WORKLOADS = {  # the quickstart's and hgnn_train_acm's ACM targets; phase 4's DBLP ones
    "ACM": ["APA", "PAP", "PSP", "PTP", "APSPA"],
    "DBLP": ["APA", "APTPA", "APVPA"],
}
FEATURE_DIM = 64


def counts(name: str, targets) -> dict:
    """Every quantity of the module docstring for one dataset."""
    g = make_dataset(name, seed=0, scale=1.0)
    out = {"targets": list(targets), "sgb": {}}
    for planner in ("naive", "ctt", "ctt_dp"):
        plan = make_plan(g, targets, planner=planner)
        res = execute_plan(g, plan)
        out["sgb"][planner] = {"compositions": plan.num_compositions,
                               "macs": res.cost.macs, "bytes": res.cost.total_bytes}
        if planner == "ctt":
            ctt = CallbackTrieTree(g.relation_names)
            for step in plan.steps:
                ctt.insert(step.out)
            out["ctt"] = {"nbytes": ctt.nbytes(), "materialized": ctt.materialized()}
    res = FrontendPipeline(PipelineConfig(pack=True), cache=SemanticGraphCache()).run(g, targets)
    out["gfp"] = {}
    for t in targets:
        rel = res.semantic[t]
        o = np.lexsort((rel.src, rel.dst))
        original = pack_edge_blocks(rel.src[o], rel.dst[o], rel.num_src, rel.num_dst)
        out["gfp"][t] = {"edges": rel.num_edges,
                         "original": original.hbm_feature_bytes(FEATURE_DIM),
                         "restructured": res.packed[t].hbm_feature_bytes(FEATURE_DIM)}
    return out


def main(argv=None) -> dict:
    names = (argv if argv is not None else sys.argv[1:]) or list(WORKLOADS)
    report = {}
    for name in names:
        c = report[name] = counts(name, WORKLOADS[name])
        for planner, s in c["sgb"].items():
            print(f"{name} SGB {planner}: {s['compositions']} compositions, {s['macs']} MACs, "
                  f"{s['bytes']} bytes")
        print(f"{name} CTT: {c['ctt']['nbytes']} bytes, {len(c['ctt']['materialized'])} "
              f"materialized metapaths")
        for t, b in c["gfp"].items():
            print(f"{name} GFP {t}: {b['edges']} edges, feature bytes {b['restructured']} "
                  f"restructured / {b['original']} original "
                  f"({b['restructured'] / b['original']:.4f})")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
