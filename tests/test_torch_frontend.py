"""Port frontend parity: the host products of ``repro_torch`` (datasets,
fingerprints, SGB, restructure, packing) are bitwise-equal to the JAX
package's on the same seeded graphs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import sgb as ref_sgb  # noqa: E402
from repro.kernels import seg_sum as ref_seg_sum  # noqa: E402
from repro.pipeline import (FrontendPipeline as RefPipeline,  # noqa: E402
                            PipelineConfig as RefConfig,
                            SemanticGraphCache as RefCache)
from repro_torch.core import sgb  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels.seg_sum import (pack_edge_blocks,  # noqa: E402
                                         pack_edge_blocks_reference)
from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,  # noqa: E402
                                  SemanticGraphCache)

# (dataset, fixture scale, targets): the conftest fixtures' scales
WORKLOADS = {
    "ACM": (0.15, ["APA", "PAP", "PSP"]),
    "IMDB": (0.2, ["AMA", "MAM", "MDM"]),
    "DBLP": (0.1, ["APA", "APTPA"]),
}
_PACKED_FIELDS = ("src_local", "dst_local", "band", "dst_tile",
                  "first_in_tile", "count", "edge_block_id", "edge_slot")


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def graphs(acm_small, imdb_small, dblp_small):
    """(reference graph, port graph) per dataset at fixture scale."""
    ref = {"ACM": acm_small, "IMDB": imdb_small, "DBLP": dblp_small}
    return {name: (ref[name], make_dataset(name, scale=WORKLOADS[name][0]))
            for name in WORKLOADS}


@pytest.fixture(scope="module")
def frontends(graphs):
    """One pack=True frontend pass per dataset on each side."""
    out = {}
    for name, (g_ref, g_port) in graphs.items():
        targets = WORKLOADS[name][1]
        r = RefPipeline(RefConfig(pack=True), cache=RefCache()).run(g_ref, targets)
        p = FrontendPipeline(PipelineConfig(pack=True),
                             cache=SemanticGraphCache()).run(g_port, targets)
        out[name] = (r, p)
    return out


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_dataset_bitwise_equal(graphs, name):
    g_ref, g_port = graphs[name]
    assert g_port.num_vertices == g_ref.num_vertices
    assert g_port.feature_dims == g_ref.feature_dims
    assert list(g_port.relations) == list(g_ref.relations)
    for rname, rel in g_ref.relations.items():
        mine = g_port.relations[rname]
        assert (mine.num_src, mine.num_dst) == (rel.num_src, rel.num_dst)
        assert _equal(mine.src, rel.src) and _equal(mine.dst, rel.dst), rname
    assert sorted(g_port.features) == sorted(g_ref.features)
    for t, x in g_ref.features.items():
        assert _equal(g_port.features[t], x), t
    assert g_port.fingerprint() == g_ref.fingerprint()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("planner", ["naive", "ctt", "ctt_cache", "ctt_dp"])
def test_sgb_plans_and_products_equal(graphs, name, planner):
    g_ref, g_port = graphs[name]
    targets = WORKLOADS[name][1]
    plan_r = ref_sgb.make_plan(g_ref, targets, planner=planner)
    plan_p = sgb.make_plan(g_port, targets, planner=planner)
    assert [repr(s) for s in plan_p.steps] == [repr(s) for s in plan_r.steps]
    res_r = ref_sgb.execute_plan(g_ref, plan_r)
    res_p = sgb.execute_plan(g_port, plan_p)
    assert res_p.cost.macs == res_r.cost.macs
    assert res_p.cost.bytes_read == res_r.cost.bytes_read
    assert res_p.cost.bytes_written == res_r.cost.bytes_written
    for t in targets:
        assert _equal(res_p.graphs[t].src, res_r.graphs[t].src)
        assert _equal(res_p.graphs[t].dst, res_r.graphs[t].dst)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_restructure_and_schedule_bitwise_equal(frontends, name):
    r, p = frontends[name]
    for mp in WORKLOADS[name][1]:
        assert _equal(p.semantic[mp].src, r.semantic[mp].src)
        assert _equal(p.semantic[mp].dst, r.semantic[mp].dst)
        rg_r, rg_p = r.restructured[mp], p.restructured[mp]
        for a, b in zip(rg_p.permutations(), rg_r.permutations()):
            assert _equal(a, b), mp
        for renumbered in (False, True):
            for a, b in zip(rg_p.scheduled_edges(renumbered),
                            rg_r.scheduled_edges(renumbered)):
                assert _equal(a, b), (mp, renumbered)
        assert _equal(rg_p.backbone.src_in, rg_r.backbone.src_in)
        assert _equal(rg_p.backbone.dst_in, rg_r.backbone.dst_in)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_packed_edges_bitwise_equal(frontends, name):
    r, p = frontends[name]
    for mp in WORKLOADS[name][1]:
        pk_r, pk_p = r.packed[mp], p.packed[mp]
        for f in _PACKED_FIELDS:
            assert _equal(getattr(pk_p, f), getattr(pk_r, f)), (mp, f)
        assert (pk_p.num_src, pk_p.num_dst) == (pk_r.num_src, pk_r.num_dst)
        assert _equal(pk_p.valid_weight(), pk_r.valid_weight())
        for a, b in zip(pk_p.flat_global_edges(), pk_r.flat_global_edges()):
            assert _equal(a, b)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_tile_block_list_partitions_schedule(frontends, name):
    _, p = frontends[name]
    for mp in WORKLOADS[name][1]:
        pk = p.packed[mp]
        tile_ptr, tile_blocks = pk.tile_blocks()
        assert tile_ptr.shape == (pk.num_dst_tiles + 1,)
        assert tile_blocks.shape == (pk.num_blocks,)
        assert tile_ptr[0] == 0 and tile_ptr[-1] == pk.num_blocks
        assert np.array_equal(np.sort(tile_blocks), np.arange(pk.num_blocks))
        for t in range(pk.num_dst_tiles):
            blocks = tile_blocks[tile_ptr[t]:tile_ptr[t + 1]]
            assert (np.diff(blocks) > 0).all()  # schedule order
            assert (pk.dst_tile[blocks] == t).all()
            if blocks.size:  # the first block of a tile is its first touch
                assert pk.first_in_tile[blocks[0]] == 1
                assert (pk.first_in_tile[blocks[1:]] == 0).all()
        # the plain versions' per-tile slot lists cover every valid edge once
        edge_ptr, blk, slot = pk.tile_edges()
        assert edge_ptr[-1] == pk.num_edges
        key = np.sort(blk * pk.edge_block + slot)
        eb, es = pk.edge_map()
        assert np.array_equal(key, np.sort(eb.astype(np.int64) * pk.edge_block + es))


def test_packer_matches_reference_on_random_streams():
    rng = np.random.default_rng(11)
    for _ in range(6):
        ns, nd = int(rng.integers(2, 1200)), int(rng.integers(2, 900))
        ne = int(rng.integers(1, 5000))
        src, dst = rng.integers(0, ns, ne), rng.integers(0, nd, ne)
        o = np.lexsort((src, dst))
        src, dst = src[o], dst[o]
        w = rng.random(ne).astype(np.float32)
        mine = pack_edge_blocks(src, dst, ns, nd, weight=w)
        loop = pack_edge_blocks_reference(src, dst, ns, nd, weight=w)
        ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd, weight=w)
        for f in _PACKED_FIELDS[:6]:
            assert np.array_equal(getattr(mine, f), getattr(loop, f)), f
            assert _equal(getattr(mine, f), getattr(ref, f)), f
        assert _equal(mine.weight, ref.weight)


def test_first_in_tile_on_nonconsecutive_revisit():
    src = np.array([0, 1, 700, 2])
    dst = np.array([0, 3, 130, 0])
    pk = pack_edge_blocks(src, dst, 1024, 256)
    np.testing.assert_array_equal(pk.dst_tile, [0, 1, 0])
    np.testing.assert_array_equal(pk.first_in_tile, [1, 1, 0])
    tile_ptr, tile_blocks = pk.tile_blocks()
    np.testing.assert_array_equal(tile_ptr, [0, 2, 3])
    np.testing.assert_array_equal(tile_blocks, [0, 2, 1])


def test_empty_stream_packs_to_zero_blocks():
    pk = pack_edge_blocks(np.zeros(0), np.zeros(0), 10, 300)
    assert pk.num_blocks == 0 and pk.num_dst_tiles == 3
    tile_ptr, tile_blocks = pk.tile_blocks()
    np.testing.assert_array_equal(tile_ptr, [0, 0, 0, 0])
    assert tile_blocks.shape == (0,)


def test_pipeline_cache_serves_second_run(graphs):
    _, g = graphs["ACM"]
    pipe = FrontendPipeline(PipelineConfig(pack=True), cache=SemanticGraphCache())
    first = pipe.run(g, ["APA", "PAP"])
    second = pipe.run(g, ["APA", "PAP"])
    assert first.cold and second.sgb is None
    assert second.cache_stats.misses == 0 and second.cache_stats.hits > 0
    for mp in ("APA", "PAP"):
        assert second.packed[mp] is first.packed[mp]


def test_device_sgb_backend_runs_on_cpu(graphs):
    """``backend="device"`` composes on the requested device (the plain
    SpGEMM on the CPU) and matches the host join; unknown backends raise."""
    _, g = graphs["ACM"]
    plan = sgb.make_plan(g, ["APA", "PSP"])
    dev = sgb.execute_plan(g, plan, backend="device", device="cpu")
    host = sgb.execute_plan(g, plan)
    assert dev.backend == "device" and dev.device_stats["compositions"] == 2
    assert dev.cost == host.cost
    for t in ("APA", "PSP"):
        assert np.array_equal(dev.graphs[t].src, host.graphs[t].src)
        assert np.array_equal(dev.graphs[t].dst, host.graphs[t].dst)
    with pytest.raises(ValueError, match="unknown backend"):
        sgb.execute_plan(g, plan, backend="tpu")
