"""The row view and work list that the CUDA NA kernels K1 and K2 read
(``PackedEdges.row_edges``), on the CPU.

The view must list every destination row's valid slots in the tile walk's
order, and the work list must cover every row once within its budgets.  A
numpy emulation of the kernels' order of summation (items, then heavy-row
partials, then their fixed-order combine) is held against the plain
versions and against the JAX package's Pallas kernels in interpret mode.
The kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import seg_sum as ref_seg_sum  # noqa: E402
from repro.kernels.edge_softmax import block_logits  # noqa: E402
from repro.kernels.edge_softmax import \
    edge_softmax_stats as ref_stats  # noqa: E402
from repro.pipeline import (FrontendPipeline as RefPipeline,  # noqa: E402
                            PipelineConfig as RefConfig,
                            SemanticGraphCache as RefCache)
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels.edge_softmax import (NEG,  # noqa: E402
                                              softmax_stats_plain)
from repro_torch.kernels.seg_sum import (ITEMS_PER_CTA,  # noqa: E402
                                         ROWS_PER_ITEM, pack_edge_blocks,
                                         seg_sum_plain, seg_sum_transposed_plain,
                                         work_list)
from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,  # noqa: E402
                                  SemanticGraphCache)

GROUP = 64  # logits a K2 warp folds at once (kGroup in na_kernels.cu)
BUDGETS = [8, 64]  # a small budget makes many heavy rows at test size


def _rows(pk, budget):
    """The packing's row view with the work list cut at ``budget``."""
    rows = pk.row_edges()
    return rows._replace(items=work_list(rows.row_ptr, budget))
DATASETS = {"acm_small": ("ACM", 0.15, ["APA", "PAP"]),
            "dblp_small": ("DBLP", 0.1, ["APTPA"])}
CASES = ["random0", "random1", "hub", "gaps", "revisit",
         "acm_small:APA", "acm_small:PAP", "dblp_small:APTPA"]


def _edges(rng, ns, nd, ne):
    src = rng.integers(0, ns, ne)
    dst = rng.integers(0, nd, ne)
    o = np.lexsort((src, dst))
    return src[o], dst[o]


def _stream(case):
    """(src, dst, num_src, num_dst) of a synthetic scheduled stream."""
    rng = np.random.default_rng(len(case))
    if case == "random0":
        return (*_edges(rng, 300, 200, 1500), 300, 200)
    if case == "random1":
        return (*_edges(rng, 2000, 700, 9000), 2000, 700)
    if case == "hub":  # row 5 takes 3,000 in-edges from four bands
        s, d = _edges(rng, 2000, 300, 2000)
        s = np.concatenate([s, rng.integers(0, 2000, 3000)])
        d = np.concatenate([d, np.full(3000, 5)])
        o = np.lexsort((s, d))
        return s[o], d[o], 2000, 300
    if case == "gaps":  # tiles 1 and 2 and most rows of 0 and 3 get nothing
        s, d = _edges(rng, 600, 40, 800)
        return s, np.where(d < 20, d, d + 400), 600, 512
    assert case == "revisit"  # tile 0 -> tile 1 -> tile 0 again
    return np.array([0, 1, 700, 2]), np.array([0, 3, 130, 0]), 1024, 256


@pytest.fixture(scope="module")
def packings(acm_small, dblp_small):
    """case -> (port packing, the JAX package's packing of the same stream)."""
    out = {}
    ref_graphs = {"acm_small": acm_small, "dblp_small": dblp_small}
    for fixture, (name, scale, targets) in DATASETS.items():
        r = RefPipeline(RefConfig(pack=True), cache=RefCache()).run(
            ref_graphs[fixture], targets)
        p = FrontendPipeline(PipelineConfig(pack=True), cache=SemanticGraphCache()
                             ).run(make_dataset(name, scale=scale), targets)
        for mp in targets:
            out[f"{fixture}:{mp}"] = (p.packed[mp], r.packed[mp])
    for case in CASES:
        if ":" not in case:
            src, dst, ns, nd = _stream(case)
            out[case] = (pack_edge_blocks(src, dst, ns, nd),
                         ref_seg_sum.pack_edge_blocks(src, dst, ns, nd))
    return out


# ------------------------------------------------------------- row view --
@pytest.mark.parametrize("case", CASES)
def test_row_view_follows_the_tile_walk(packings, case):
    pk, pk_ref = packings[case]
    rows = pk.row_edges()
    _, blk, slot = pk.tile_edges()
    dst = pk.dst_tile[blk].astype(np.int64) * pk.dst_tile_rows + pk.dst_local[blk, slot]
    src = pk.band[blk].astype(np.int64) * pk.src_band + pk.src_local[blk, slot]
    flat = blk * pk.edge_block + slot
    assert rows.row_ptr.shape == (pk.num_dst + 1,) and rows.row_ptr[-1] == pk.num_edges
    assert rows.row_ptr.dtype == rows.row_src.dtype == rows.row_slot.dtype == np.int32
    for r in range(pk.num_dst):  # each row: the tile walk filtered to it, in order
        a, b = rows.row_ptr[r], rows.row_ptr[r + 1]
        mask = dst == r
        assert np.array_equal(rows.row_src[a:b], src[mask])
        assert np.array_equal(rows.row_slot[a:b], flat[mask])
    # the same multiset of edges as the reference's flat scheduled stream
    rsrc, rdst = pk_ref.flat_global_edges()
    mine_dst = np.repeat(np.arange(pk.num_dst), np.diff(rows.row_ptr))
    mine = np.lexsort((rows.row_src, mine_dst))
    ref = np.lexsort((rsrc, rdst))
    assert np.array_equal(rows.row_src[mine], np.asarray(rsrc)[ref])
    assert np.array_equal(mine_dst[mine], np.asarray(rdst)[ref])
    # only valid slots: every slot index lies in its block's valid prefix
    assert (rows.row_slot % pk.edge_block < pk.count[rows.row_slot // pk.edge_block]).all()


def _assert_covers_every_row_once(rows, n_rows, budget):
    ptr, items = rows.row_ptr.astype(np.int64), rows.items
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert items.shape[0] % ITEMS_PER_CTA == 0
    cover = np.zeros(n_rows, np.int64)
    i = 0
    while i < items.shape[0]:
        row, kind, e0, e1 = (int(x) for x in items[i])
        if kind == 0:  # idle padding
            assert (row, e0, e1) == (0, 0, 0)
            i += 1
        elif kind > 0:  # a run of whole rows within both budgets
            assert kind <= ROWS_PER_ITEM
            assert (e0, e1) == (ptr[row], ptr[row + kind])
            assert e1 - e0 <= budget
            cover[row:row + kind] += 1
            i += 1
        else:  # a heavy row: -k first, then k - 1 slices, in one CTA
            k = -kind
            assert k >= 2 and i // ITEMS_PER_CTA == (i + k - 1) // ITEMS_PER_CTA
            group = items[i:i + k]
            assert (group[:, 0] == row).all() and (group[1:, 1] == -1).all()
            assert group[0, 2] == ptr[row] and group[-1, 3] == ptr[row + 1]
            assert np.array_equal(group[1:, 2], group[:-1, 3])  # contiguous, ordered
            deg = ptr[row + 1] - ptr[row]
            assert deg > budget
            sizes = group[:, 3] - group[:, 2]
            assert (sizes > 0).all()
            # only a row that needs more than a CTA's warps exceeds the budget
            assert (sizes <= budget).all() or k == ITEMS_PER_CTA
            cover[row] += 1
            i += k
    assert (cover == 1).all()


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_work_list_covers_every_row_once(packings, case, budget):
    pk, _ = packings[case]
    _assert_covers_every_row_once(_rows(pk, budget), pk.num_dst, budget)


def test_work_list_fills_heavy_ctas_with_light_items():
    # rows of degree 2, 300, 2, 2, 200, 2 at budget 64: the 5-slice group
    # opens CTA 0, the 4-slice group does not fit beside it, so the light
    # runs fill CTA 0 and the group opens CTA 1, padded with idle items
    ptr = np.cumsum([0, 2, 300, 2, 2, 200, 2])
    items = work_list(ptr, budget=64)
    assert items[:, 1].tolist() == [-5, -1, -1, -1, -1, 1, 2, 1,
                                    -4, -1, -1, -1, 0, 0, 0, 0]
    assert items[5:8].tolist() == [[0, 1, 0, 2], [2, 2, 302, 306], [5, 1, 506, 508]]
    assert items[8].tolist() == [4, -4, 306, 356]
    assert work_list(np.zeros(1, np.int64)).shape == (0, 4)  # no rows, no work


# ------------------------------------------- the kernels' order, emulated --
def _emulate_k1(rows, h, w_flat, num_dst):
    """K1's order: each row (or heavy slice) summed edge by edge from 0,
    slices added in order by the warp of the first."""
    def run(a, b):
        terms = w_flat[rows.row_slot[a:b], None] * h[rows.row_src[a:b]]
        if a == b:
            return np.zeros(h.shape[1], np.float32)
        return np.cumsum(terms, axis=0, dtype=np.float32)[-1]

    out = np.zeros((num_dst, h.shape[1]), np.float32)
    part = {}
    for i, (row, kind, e0, e1) in enumerate(rows.items):
        if kind > 0:
            for r in range(row, row + kind):
                out[r] = run(rows.row_ptr[r], rows.row_ptr[r + 1])
        elif kind < 0:
            part[i] = run(e0, e1)
    for i, (row, kind, _, _) in enumerate(rows.items):
        if kind <= -2:
            tot = part[i]
            for j in range(1, -kind):
                tot = tot + part[i + j]
            out[row] = tot
    return out


def _emulate_k2(rows, l_flat, num_dst):
    """K2's order: a light row's max, then its sum of exponentials; a heavy
    slice folds 64 logits at a time; slices combine in order."""
    m = np.full(num_dst, NEG, np.float32)
    s = np.zeros(num_dst, np.float32)
    part = {}
    for i, (row, kind, e0, e1) in enumerate(rows.items):
        if kind > 0:
            for r in range(row, row + kind):
                v = l_flat[rows.row_slot[rows.row_ptr[r]:rows.row_ptr[r + 1]]]
                if v.size:
                    m[r] = v.max()
                    s[r] = np.exp(v - m[r]).sum(dtype=np.float32)
        elif kind < 0:
            mm, ss = np.float32(NEG), np.float32(0.0)
            for g in range(e0, e1, GROUP):
                v = l_flat[rows.row_slot[g:min(g + GROUP, e1)]]
                mn = max(mm, v.max())
                ss = ss * np.exp(mm - mn) + np.exp(v - mn).sum(dtype=np.float32)
                mm = mn
            part[i] = (mm, ss)
    for i, (row, kind, _, _) in enumerate(rows.items):
        if kind <= -2:
            ms = [part[i + j] for j in range(-kind)]
            m[row] = max(p[0] for p in ms)
            s[row] = sum(p[1] * np.exp(p[0] - m[row]) for p in ms)
    return m, s


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_k1_order_matches_plain_and_jax(packings, case, budget):
    pk, pk_ref = packings[case]
    rng = np.random.default_rng(budget)
    h = rng.standard_normal((pk.num_src, 8)).astype(np.float32)
    # random weights over 1 / in-degree, the scale the mean and attention
    # paths give them, so the hub row's sum stays of the size of its terms
    _, dst = pk.flat_global_edges()
    deg = np.bincount(dst, minlength=pk.num_dst).astype(np.float32)
    w = np.zeros(pk.src_local.shape, np.float32)
    blk, slot = pk.edge_map()
    w[blk, slot] = rng.random(blk.size).astype(np.float32) / deg[dst]
    got = _emulate_k1(_rows(pk, budget), h, w.reshape(-1), pk.num_dst)
    plain = seg_sum_plain(pk, torch.from_numpy(h), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    want = ref_seg_sum.seg_sum_na(pk_ref, jnp.asarray(h), interpret=True,
                                  weights=jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want)[:pk.num_dst], atol=1e-4, rtol=1e-4)
    empty = np.diff(pk.row_edges().row_ptr) == 0
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_k2_order_matches_plain_and_jax(packings, case, budget):
    pk, pk_ref = packings[case]
    rng = np.random.default_rng(budget + 1)
    logits = (rng.standard_normal(pk.num_edges) * 3).astype(np.float32)
    lb = pk.scatter_blocks(torch.from_numpy(logits), fill=NEG)
    m, s = _emulate_k2(_rows(pk, budget), lb.numpy().reshape(-1), pk.num_dst)
    m_p, s_p = softmax_stats_plain(pk, lb)
    assert np.array_equal(m, m_p.numpy())  # a max is exact
    np.testing.assert_allclose(s, s_p.numpy(), rtol=1e-5, atol=1e-5)
    m_r, s_r = ref_stats(pk_ref, block_logits(pk_ref, logits), interpret=True)
    assert np.array_equal(m, np.asarray(m_r)[:pk.num_dst])
    np.testing.assert_allclose(s, np.asarray(s_r)[:pk.num_dst], rtol=1e-5, atol=1e-5)
    empty = np.diff(pk.row_edges().row_ptr) == 0
    assert (m[empty] == NEG).all() and (s[empty] == 0).all()


# ------------------------------------ the source-major view (backward) --
def _src_rows(pk, budget):
    rows = pk.src_edges()
    return rows._replace(items=work_list(rows.row_ptr, budget))


@pytest.mark.parametrize("case", CASES)
def test_src_view_follows_the_flat_stream(packings, case):
    """Each source's edges in schedule order (the flat stream filtered to
    it), each edge's destination and flat slot, and a work list that
    covers every source row once."""
    pk, _ = packings[case]
    rows = pk.src_edges()
    src, dst = pk.flat_global_edges()
    blk, slot = pk.edge_map()
    flat = blk.astype(np.int64) * pk.edge_block + slot
    assert rows.row_ptr.shape == (pk.num_src + 1,) and rows.row_ptr[-1] == pk.num_edges
    assert rows.row_ptr.dtype == rows.row_src.dtype == rows.row_slot.dtype == np.int32
    order = np.argsort(src, kind="stable")
    assert np.array_equal(rows.row_src, dst[order])
    assert np.array_equal(rows.row_slot, flat[order])
    for s_ in np.unique(src)[:50]:
        a, b = rows.row_ptr[s_], rows.row_ptr[s_ + 1]
        assert np.array_equal(rows.row_src[a:b], dst[src == s_])
    assert np.array_equal(np.diff(rows.row_ptr), np.bincount(src, minlength=pk.num_src))
    assert pk.src_edges() is rows  # memoized
    _assert_covers_every_row_once(rows, pk.num_src, 64)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_k1_over_src_view_matches_plain_scatter(packings, case, budget):
    """K1's order over the source-major view (the backward's launch)
    against a plain scatter of ``w_e g[dst_e]`` into ``src_e`` and against
    the port's plain transposed version."""
    pk, _ = packings[case]
    rng = np.random.default_rng(budget + 2)
    g = rng.standard_normal((pk.num_dst, 8)).astype(np.float32)
    src, dst = pk.flat_global_edges()
    blk, slot = pk.edge_map()
    w = np.zeros(pk.src_local.shape, np.float32)
    w[blk, slot] = rng.random(blk.size).astype(np.float32)
    got = _emulate_k1(_src_rows(pk, budget), g, w.reshape(-1), pk.num_src)
    want = np.zeros((pk.num_src, 8), np.float64)
    np.add.at(want, src, w[blk, slot, None].astype(np.float64) * g[dst])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    plain = seg_sum_transposed_plain(pk, torch.from_numpy(g), torch.from_numpy(w))
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-4, rtol=1e-5)
    empty = np.diff(pk.src_edges().row_ptr) == 0
    assert (got[empty] == 0).all()
