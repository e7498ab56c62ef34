"""The port's four example flows (``repro_torch.examples``) on the CPU at a
small scale, their products held against the JAX package's example flows
(``examples/*.py``) on the same seeds: SGB composition counts and MACs,
logits, labels, the restructurer's numbers and the LM's tokens."""
import contextlib
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.train.hgnn_step as ref_step  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import buffersim as ref_buffersim  # noqa: E402
from repro.core import restructure as ref_restructure  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.hetero import make_dataset as ref_make_dataset  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.api import device_features  # noqa: E402
from repro_torch.core.hgnn import params_from_numpy  # noqa: E402
from repro_torch.examples import (hgnn_train_acm, lm_serve_demo, quickstart,  # noqa: E402
                                  restructure_demo)
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.models.lm import lm_params_from_numpy  # noqa: E402

LOGIT_ATOL = 1e-4  # the session parity tests' (tests/test_torch_models.py)
SCALE = 0.1


@pytest.fixture(scope="module")
def quick():
    """The flow's products, and what it printed under ``"stdout"``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart.main([str(SCALE), "--device", "cpu"])
    return dict(out, stdout=buf.getvalue())


def test_quickstart_sgb_and_logits_match_the_reference_flow(quick):
    """The reference flow's compile of shgn over ACM: the same SGB
    compositions and MACs, the same frontend reuse after the rgcn compile,
    and logits within 1e-4 from the reference's parameters."""
    g_ref = ref_make_dataset("ACM", scale=SCALE)
    sess = ref_api.Session(ref_api.ExecutorSpec(planner="ctt", sgb_backend="host"))
    cfg = dict(hidden=64, num_layers=2, num_classes=3, target_type="P")
    shgn = sess.compile(g_ref, quickstart.TARGETS, RefConfig(model="shgn", **cfg))
    sess.compile(g_ref, quickstart.TARGETS, RefConfig(model="rgcn", **cfg))
    res, res_ref = quick["shgn"].frontend, shgn.frontend
    assert len(res.sgb.per_step) == len(res_ref.sgb.per_step)
    assert res.sgb.cost.macs == res_ref.sgb.cost.macs
    assert quick["graph"].total_edges() == g_ref.total_edges()
    st = sess.stats()
    assert (f"warm compile: frontend ran {st.frontend_runs}x, served "
            f"{st.frontend_served}x from the session") in quick["stdout"]
    assert f"SGB: {len(res_ref.sgb.per_step)} compositions" in quick["stdout"]
    p_ref = shgn.init(0)
    want = np.asarray(shgn.forward(p_ref, ref_api.device_features(g_ref)))
    got = quick["shgn"].forward(params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu"),
                                device_features(quick["graph"], "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


def test_quickstart_serves_rows_of_its_compiled_forwards(quick):
    """Each served response is, bit for bit, the rows of one compiled
    forward with the parameters of the version that served it: v1 and v2
    on the registered ACM and IMDB, v3 on the graph the delta made."""
    acm_c, imdb_c = quick["shgn"], quick["imdb_tenant"].compiled
    g2 = quick["graph"].apply_delta(quick["delta"])
    p1 = acm_c.init(0)
    forwards = {
        ("acm", 1): acm_c.forward(p1, device_features(quick["graph"], "cpu")),
        ("acm", 2): acm_c.forward(quick["swapped_params"],
                                  device_features(quick["graph"], "cpu")),
        ("acm", 3): quick["acm"].compiled.forward(quick["swapped_params"],
                                                  device_features(g2, "cpu")),
        ("imdb", 1): imdb_c.forward(imdb_c.init(0), device_features(quick["imdb"], "cpu")),
    }
    assert [(r.graph, r.params_version, r.mode) for r in quick["responses"]] == [
        ("acm", 1, "subset"), ("imdb", 1, "subset"), ("acm", 1, "full"),
        ("acm", 2, "subset"), ("acm", 3, "subset")]
    for r in quick["responses"]:
        full = forwards[(r.graph, r.params_version)].numpy()
        # the flow's subset requests ask for the first 8 (ACM) or 4 (IMDB) ids
        rows = full if r.mode == "full" else full[: r.logits.shape[0]]
        assert np.array_equal(r.logits, rows)


def test_hgnn_train_acm_labels_and_losses(capsys):
    """A 3-step banded run at scale 0.05: labels and masks bitwise the
    reference flow's (labels from ``compiled.semantic``), losses finite."""
    out = hgnn_train_acm.main(["--scale", "0.05", "--steps", "3", "--na-executor", "banded",
                               "--device", "cpu"])
    g_ref = ref_make_dataset("ACM", scale=0.05)
    compiled = ref_api.Session(ref_api.ExecutorSpec()).compile(
        g_ref, hgnn_train_acm.TARGETS, RefConfig(model="rgat", hidden=64, num_layers=3,
                                                 num_classes=3, target_type="P"))
    n = compiled.num_target
    labels = ref_step.propagated_feature_labels(compiled.semantic, hgnn_train_acm.TARGETS,
                                                g_ref.features, n)
    assert out["labels"].dtype == torch.int32
    assert np.array_equal(out["labels"].numpy(), np.asarray(labels))
    masks = ref_step.semi_supervised_masks(n, seed=0)
    for k in ("train", "val", "test"):
        assert np.array_equal(out["masks"][k].numpy(), np.asarray(masks[k]))
    losses = out["fit"]["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done [banded]" in capsys.readouterr().out


def test_restructure_demo_numbers_match_the_reference_flow(monkeypatch):
    """The flow at scale 0.2 (its datasets cut): every size and hit rate
    the reference flow computes, equal."""
    monkeypatch.setattr(restructure_demo, "make_dataset",
                        functools.partial(make_dataset, scale=0.2))
    out = restructure_demo.main(["--device", "cpu"])
    for ds in restructure_demo.DATASETS:
        g = ref_make_dataset(ds, scale=0.2)
        rel = max(g.relations.values(), key=lambda r: r.num_edges)
        ms, md = ref_restructure.decouple(rel)
        rg = ref_restructure.recouple(rel, ms, md)
        orig = ref_buffersim.simulate_na(
            ref_buffersim.na_edge_stream_original(rel.src, rel.dst), 64, 64 * 1024,
            num_rows=rel.num_src)
        rest = ref_buffersim.simulate_na(rg.scheduled_edges()[0], 64, 64 * 1024,
                                         num_rows=rel.num_src)
        assert out[ds] == {
            "relation": rel.name, "num_src": rel.num_src, "num_dst": rel.num_dst,
            "num_edges": rel.num_edges, "matching": int((ms >= 0).sum()),
            "backbone": rg.backbone.size,
            "subgraphs": [(s.kind, s.num_src, s.num_dst, s.num_edges) for s in rg.subgraphs],
            "hit_rate": (orig.hit_rate, rest.hit_rate),
            "dram_bytes": (orig.dram_bytes, rest.dram_bytes),
        }


def test_lm_serve_demo_tokens_match_the_reference_engine():
    """Reduced smollm-135m from the reference's parameters: every request
    yields its 6 tokens, the reference engine's tokens."""
    cfg = ref_reduced(ref_get_config("smollm-135m"))
    model = RefLM(cfg, backend="jnp", remat="none")
    params = model.init(jax.random.key(0))
    out = lm_serve_demo.main(["--device", "cpu"],
                             params=lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                         "cpu"))
    reqs = [RefRequest(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in out["requests"]]
    done = RefEngine(model, params, batch_slots=4, max_len=48).run(reqs, max_steps=64)
    assert sorted(out["done"]) == sorted(done) == list(range(6))
    for rid in done:
        assert len(out["done"][rid]) == 6
        assert out["done"][rid] == [int(t) for t in done[rid]]
