"""Port parity for the NA feature-buffer simulator
(``repro_torch.core.buffersim``): ``BufferStats`` fields and the
replacement histogram bitwise equal to the reference's
(``repro.core.buffersim``) over the original and the restructured streams
of ACM, DBLP and IMDB, the dual-stream model and the cycle model, and the
restructurer's locality claim (``tests/test_restructure.py``) on the
port's own streams."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import buffersim as ref_bs  # noqa: E402
from repro.core.restructure import restructure as ref_restructure  # noqa: E402
from repro.hetero import make_dataset as ref_make_dataset  # noqa: E402
from repro_torch.core import buffersim as bs  # noqa: E402
from repro_torch.core.restructure import restructure  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402

DATASETS = ("ACM", "DBLP", "IMDB")
CAPACITY = 64 * 1024  # bytes, tests/test_restructure.py:110
FEATURE_DIM = 64
FIELDS = ("accesses", "hits", "misses", "evictions", "dram_bytes", "capacity_bytes",
          "line_bytes")


@pytest.fixture(scope="module")
def streams():
    """Per dataset at scale 1.0, each package's largest relation and its
    original and restructured source streams."""
    out = {}
    for ds in DATASETS:
        pair = {}
        for side, make, rs, mod in (("ref", ref_make_dataset, ref_restructure, ref_bs),
                                    ("port", make_dataset, restructure, bs)):
            rel = max(make(ds).relations.values(), key=lambda r: r.num_edges)
            s, d = rs(rel).scheduled_edges()
            pair[side] = {"rel": rel, "original": (mod.na_edge_stream_original(
                rel.src, rel.dst), np.sort(rel.dst)), "restructured": (s, d)}
        out[ds] = pair
    return out


def _assert_same(got, want):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.replacements_per_vertex.dtype == want.replacements_per_vertex.dtype
    np.testing.assert_array_equal(got.replacements_per_vertex, want.replacements_per_vertex)
    assert got.hit_rate == want.hit_rate
    for bucket in (4, 8):
        g, w = got.replacement_histogram(bucket), want.replacement_histogram(bucket)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("order", ["original", "restructured"])
@pytest.mark.parametrize("line_rows", [1, 16])
def test_stats_bitwise_the_reference(streams, ds, order, line_rows):
    ref, port = streams[ds]["ref"], streams[ds]["port"]
    np.testing.assert_array_equal(port[order][0], ref[order][0])
    num_rows = port["rel"].num_src
    got = bs.simulate_na(port[order][0], FEATURE_DIM, CAPACITY, line_rows=line_rows,
                         num_rows=num_rows)
    want = ref_bs.simulate_na(ref[order][0], FEATURE_DIM, CAPACITY, line_rows=line_rows,
                              num_rows=num_rows)
    _assert_same(got, want)


@pytest.mark.parametrize("ds", DATASETS)
def test_dual_stream_bitwise_the_reference(streams, ds):
    ref, port = streams[ds]["ref"], streams[ds]["port"]
    rel = port["rel"]
    for order in ("original", "restructured"):
        got = bs.simulate_na_dual(*port[order], rel.num_src, rel.num_dst, FEATURE_DIM,
                                  CAPACITY)
        want = ref_bs.simulate_na_dual(*ref[order], rel.num_src, rel.num_dst, FEATURE_DIM,
                                       CAPACITY)
        _assert_same(got, want)


def test_cycle_model_and_empty_stream():
    for macs, nbytes in ((0, 0), (10 ** 6, 10 ** 5), (10 ** 4, 10 ** 7)):
        assert (bs.GFPCycleModel().cycles(macs, nbytes)
                == ref_bs.GFPCycleModel().cycles(macs, nbytes))
    _assert_same(bs.simulate_na(np.zeros(0, np.int64), 8, 1024),
                 ref_bs.simulate_na(np.zeros(0, np.int64), 8, 1024))


@pytest.mark.parametrize("ds", DATASETS)
def test_restructure_improves_locality(streams, ds):
    """The headline claim on the port's streams: the restructured order
    hits the buffer more often and fetches fewer bytes."""
    port = streams[ds]["port"]
    n = port["rel"].num_src
    orig = bs.simulate_na(port["original"][0], FEATURE_DIM, CAPACITY, num_rows=n)
    rest = bs.simulate_na(port["restructured"][0], FEATURE_DIM, CAPACITY, num_rows=n)
    assert rest.hit_rate > orig.hit_rate
    assert rest.dram_bytes < orig.dram_bytes


def test_affinity_modes_ordering_quality():
    rel = make_dataset("ACM").relation("PP")
    rates = {aff: bs.simulate_na(restructure(rel, affinity=aff).scheduled_edges()[0],
                                 FEATURE_DIM, CAPACITY, num_rows=rel.num_src).hit_rate
             for aff in ("none", "minsrc", "barycenter")}
    assert rates["barycenter"] >= rates["minsrc"] >= rates["none"] * 0.98
