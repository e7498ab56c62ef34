"""Quickstart: the paper's full pipeline through one ``repro_torch.api.Session``.

A Session owns the cached frontend (SGB -> Graph Restructurer -> packing);
``compile`` binds a model to those products once, and the result runs with
no backend arguments.  The same session then feeds the multi-tenant
serving engine.

  python -m repro_torch.examples.quickstart [scale] [--device cpu]

On the card (the default) the banded NA executor runs kernels K1 and K2;
``--device cpu`` runs their plain versions.
"""
import argparse

import numpy as np

from repro_torch.api import ExecutorSpec, ServePolicy, Session, device_features
from repro_torch.core.hgnn import HGNNConfig
from repro_torch.hetero import GraphDelta, make_dataset
from repro_torch.serve import HGNNRequest, HGNNServeEngine

TARGETS = ["APA", "PAP", "PSP", "APSPA"]
IMDB_TARGETS = ["AMA", "MAM", "MKM"]


def main(argv=None) -> dict:
    """Run the flow; returns its products (the graph, the compiled models,
    their parameters and logits, the served responses, the engine)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1) heterogeneous graph (synthetic ACM, Table-2-faithful)
    g = make_dataset("ACM", scale=args.scale)
    print(f"HetG: {g.num_vertices}  edges={g.total_edges()}")

    # 2) one session = one executor spec + one cached frontend engine
    sess = Session(ExecutorSpec(planner="ctt", sgb_backend="host", device=args.device))

    # 3) compile-and-run: SGB + restructure happen here (once), and the
    # compiled model exposes init/forward/loss/fit with no backend arguments
    shgn = sess.compile(g, TARGETS, HGNNConfig(
        model="shgn", hidden=64, num_layers=2, num_classes=3, target_type="P"))
    res = shgn.frontend
    print(f"SGB: {len(res.sgb.per_step)} compositions, "
          f"{res.sgb.cost.macs / 1e6:.1f} M MACs, "
          f"{res.timings['total'] * 1e3:.0f} ms frontend")

    feats = device_features(g, args.device)
    params = shgn.init(0)
    logits = shgn.forward(params, feats)
    print(f"GFP: logits {tuple(logits.shape)}, prediction histogram "
          f"{np.bincount(logits.argmax(-1).cpu().numpy(), minlength=3)}")

    # 4) a second model over the same graph is pure reuse: the session
    # serves every frontend product from its memo (the multi-model scenario)
    rgcn = sess.compile(g, TARGETS, HGNNConfig(
        model="rgcn", hidden=64, num_layers=2, num_classes=3, target_type="P"))
    rgcn_params = rgcn.init(0)
    rgcn_logits = rgcn.forward(rgcn_params, feats)
    st = sess.stats()
    print(f"warm compile: frontend ran {st.frontend_runs}x, "
          f"served {st.frontend_served}x from the session "
          f"(one PackedEdges/batch set shared by both models)")

    # 5) async multi-tenant serving: two graphs on one engine, each
    # registration handing back a TenantHandle; the background loop batches
    # each graph's queued requests through one compiled forward (node-subset
    # micro-batch when coverage is small, full-graph otherwise)
    imdb = make_dataset("IMDB", scale=args.scale)
    engine = HGNNServeEngine(session=sess, policy=ServePolicy(
        subset_threshold=0.5, max_queue=256))
    acm = engine.register("acm", g, TARGETS, shgn.cfg)
    imdb_t = engine.register("imdb", imdb, IMDB_TARGETS, HGNNConfig(
        model="rgat", hidden=64, num_layers=2, num_classes=3, target_type="M"))
    engine.run()  # submit() now returns at once; a daemon thread serves
    try:
        responses = [
            acm.submit(HGNNRequest(0, nodes=np.arange(8))).result(timeout=120),
            imdb_t.submit(HGNNRequest(1, nodes=np.arange(4))).result(timeout=120),
        ]
        # a nodes=None request asks for every target vertex, so its group
        # takes the full-graph forward instead of the subset path
        responses.append(acm.submit(HGNNRequest(2)).result(timeout=120))
        for r in responses:
            print(f"served rid={r.rid} graph={r.graph} mode={r.mode} "
                  f"logits={r.logits.shape} v{r.params_version} "
                  f"latency={r.latency_us / 1e3:.1f} ms "
                  f"(queue {r.queue_us / 1e3:.1f} + compute "
                  f"{r.compute_us / 1e3:.1f}; batched with {r.batched_with})")

        # 6) parameter hot-swap: install fresh params into the live
        # registration through its handle; the version stamps every later
        # response
        swapped = shgn.init(1)
        v = acm.swap_params(swapped)
        r = acm.submit(HGNNRequest(3, nodes=np.arange(8))).result(timeout=120)
        responses.append(r)
        print(f"hot-swap: registration now v{v}, response served by "
              f"v{r.params_version}")

        # 7) topology hot-swap: a GraphDelta (fresh paper-subject edges)
        # flows through the incremental frontend, and the successor model
        # installs atomically under the same version stamp
        ps = g.relations["PS"]
        rng = np.random.default_rng(7)
        delta = GraphDelta.insert("PS", rng.integers(0, ps.num_src, 4),
                                  rng.integers(0, ps.num_dst, 4))
        v = acm.swap_graph(delta)
        r = acm.submit(HGNNRequest(4, nodes=np.arange(8))).result(timeout=120)
        responses.append(r)
        print(f"graph-swap: registration now v{v} "
              f"(fingerprint {acm.fingerprint[:8]}...), response served by "
              f"v{r.params_version}")
    finally:
        engine.stop()

    s = engine.stats()
    print(f"serve: batching_factor={s['batching_factor']:.1f} "
          f"forwards={s['forwards_full']} full + {s['forwards_subset']} subset, "
          f"p50={s['latency_us_p50'] / 1e3:.1f} ms "
          f"(queue p50 {s['queue_us_p50'] / 1e3:.1f} ms, compute p50 "
          f"{s['compute_us_p50'] / 1e3:.1f} ms) over "
          f"{s['graphs_registered']} graphs")
    return {"graph": g, "imdb": imdb, "session": sess, "shgn": shgn, "params": params,
            "logits": logits, "rgcn": rgcn, "rgcn_params": rgcn_params,
            "rgcn_logits": rgcn_logits, "engine": engine, "acm": acm, "imdb_tenant": imdb_t,
            "swapped_params": swapped, "delta": delta, "responses": responses}


if __name__ == "__main__":
    main()
