"""The benchmark's frozen inputs against the port's own."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, SMALL_LM


@pytest.mark.parametrize("name", ["DBLP", "ACM", "IMDB"])
def test_generator_copy_is_bitwise_the_ports(name):
    from gbench import datagen
    from repro_torch.hetero.datasets import make_dataset

    ours = datagen.make_graph(name, seed=5, scale=0.1)
    port = make_dataset(name, seed=5, scale=0.1)
    assert ours["num_vertices"] == port.num_vertices
    assert ours["feature_dims"] == port.feature_dims
    assert sorted(ours["relations"]) == sorted(port.relations)
    for rname, (s, d) in ours["relations"].items():
        r = port.relations[rname]
        assert s.dtype == r.src.dtype and d.dtype == r.dst.dtype
        assert np.array_equal(s, r.src) and np.array_equal(d, r.dst), rname
    assert sorted(ours["features"]) == sorted(port.features)
    for t, x in ours["features"].items():
        assert x.dtype == port.features[t].dtype
        assert np.array_equal(x, port.features[t]), t


def test_generator_without_features_gives_the_same_topology():
    from gbench import datagen

    a = datagen.make_graph("DBLP", seed=0, scale=0.1)
    b = datagen.make_graph("DBLP", seed=0, scale=0.1, features=False)
    assert b["features"] == {}
    for k, (s, d) in a["relations"].items():
        assert np.array_equal(s, b["relations"][k][0]) and np.array_equal(d, b["relations"][k][1])


def test_seeds_renumber_the_same_graph():
    from gbench import datagen, hgnn_inputs

    g = datagen.make_graph("DBLP", seed=0, scale=0.1, features=False)
    a = hgnn_inputs.permuted_relations(g, 1)
    b = hgnn_inputs.permuted_relations(g, 2)
    again = hgnn_inputs.permuted_relations(g, 1)
    for k in g["relations"]:
        assert a[k][0].size == b[k][0].size == g["relations"][k][0].size
        assert np.array_equal(a[k][0], again[k][0]) and np.array_equal(a[k][1], again[k][1])
        # out-degree multisets are kept by a renumbering
        deg = lambda s, n: np.sort(np.bincount(s, minlength=n))  # noqa: E731
        n = g["num_vertices"][k[0]]
        assert np.array_equal(deg(a[k][0], n), deg(g["relations"][k][0], n))
    assert any(not np.array_equal(a[k][0], b[k][0]) for k in g["relations"])


def test_masks_are_the_ports():
    from gbench import hgnn_inputs
    from repro_torch.train.hgnn_step import semi_supervised_masks

    ours = hgnn_inputs.semi_supervised_masks(1000, 9, 0.6, 0.2, "cpu")
    port = semi_supervised_masks(1000, seed=9, device="cpu")
    for k in ("train", "val", "test"):
        assert torch.equal(ours[k], port[k])


def test_hgnn_params_have_the_ports_tree():
    from gbench import hgnn_inputs
    from repro_torch.core.hgnn.models import HGNNConfig, init_params

    cfg = json.load(open(BENCH_DIR / "configs" / "shgn-dblp.json"))
    m = cfg["model"]
    dims = {"A": 334, "P": 4231, "T": 50, "V": 0}
    ours = hgnn_inputs.shgn_params(3, m, dims, sorted(cfg["metapaths"]), "cpu")
    port = init_params(3, HGNNConfig(**{k: m[k] for k in (
        "model", "hidden", "num_layers", "num_classes", "target_type", "edge_emb_dim",
        "sf_att_dim")}), dims, sorted(cfg["metapaths"]), device="cpu")
    _same_tree(ours, port)


def test_lm_params_have_the_ports_tree():
    from gbench import common, lm_inputs
    from repro_torch.models.lm import init_params

    cfg = json.load(open(BENCH_DIR / "configs" / "granite-moe-1b-a400m.json"))
    _same_tree(lm_inputs.params(dict(cfg, **SMALL_LM), 3, "cpu"),
               init_params(3, common.arch_config(dict(cfg, **SMALL_LM)), device="cpu"))
    # the full configuration's shapes, without memory
    full = init_params(0, common.arch_config(cfg), device="meta")
    assert tuple(full["embed"].shape) == (cfg["padded_vocab"], cfg["d_model"])


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)


def test_token_stream_replays_from_its_seed():
    from gbench import lm_inputs

    s = lm_inputs.TokenStream(500, 2, 16, 11, "cpu")
    first = s.take(3)
    s.restart()
    again = s.take(3)
    for (a, b), (c, d) in zip(first, again):
        assert torch.equal(a, c) and torch.equal(b, d)
        assert torch.equal(a[:, 1:], b[:, :-1])
    assert not torch.equal(first[0][0], first[1][0])
