"""Graph Restructurer walkthrough: decouple -> backbone -> recouple, with
the buffer-thrashing measurement of paper Figs. 3/4/17.

  python -m repro_torch.examples.restructure_demo [--device cpu]

The flow runs on the host (numpy), as the reference's does, so
``--device`` changes nothing; it is taken for the examples' common
command line.
"""
import argparse

from repro_torch.core.buffersim import na_edge_stream_original, simulate_na
from repro_torch.core.restructure import decouple, recouple
from repro_torch.hetero import make_dataset

DATASETS = ("ACM", "DBLP", "IMDB")


def main(argv=None) -> dict:
    """Run the flow; returns, per dataset, the sizes and hit rates it
    prints."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.parse_args(argv)

    out = {}
    for ds in DATASETS:
        g = make_dataset(ds)
        rel = max(g.relations.values(), key=lambda r: r.num_edges)
        ms, md = decouple(rel)  # Algorithm 1
        rg = recouple(rel, ms, md)  # Algorithm 2
        rg.validate()
        print(f"\n{ds} {rel.name}: |V|=({rel.num_src},{rel.num_dst}) |E|={rel.num_edges}")
        print(f"  matching={int((ms >= 0).sum())}  backbone={rg.backbone.size} "
              f"(König: equal)  subgraphs: " +
              ", ".join(f"{s.kind}:{s.num_edges}e" for s in rg.subgraphs))
        orig = simulate_na(na_edge_stream_original(rel.src, rel.dst), 64,
                           64 * 1024, num_rows=rel.num_src)
        rest = simulate_na(rg.scheduled_edges()[0], 64, 64 * 1024,
                           num_rows=rel.num_src)
        print(f"  NA buffer: hit {orig.hit_rate:.3f} -> {rest.hit_rate:.3f}, "
              f"DRAM bytes x{rest.dram_bytes / orig.dram_bytes:.2f}")
        out[ds] = {
            "relation": rel.name, "num_src": rel.num_src, "num_dst": rel.num_dst,
            "num_edges": rel.num_edges, "matching": int((ms >= 0).sum()),
            "backbone": rg.backbone.size,
            "subgraphs": [(s.kind, s.num_src, s.num_dst, s.num_edges) for s in rg.subgraphs],
            "hit_rate": (orig.hit_rate, rest.hit_rate),
            "dram_bytes": (orig.dram_bytes, rest.dram_bytes),
        }
    return out


if __name__ == "__main__":
    main()
