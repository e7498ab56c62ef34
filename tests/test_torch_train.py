"""HGNN training in the port on the CPU against the JAX package's
``repro.train``: the optimizer on identical inputs, masks and labels bit
for bit, a short train-step trajectory from the same parameters, ``fit``
with checkpoints and resume, and checkpoints that cross between the
packages."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.train.hgnn_step as ref_step  # noqa: E402
import repro.train.optim as ref_optim  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RefCheckpoints  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.train import (AdamWState, CheckpointManager,  # noqa: E402
                               HGNNTrainState, adamw_init, adamw_update,
                               clip_by_global_norm, degree_bucket_labels,
                               make_train_step, propagated_feature_labels,
                               semi_supervised_masks, train_state_from_numpy,
                               tree_flatten, tree_leaves, tree_map,
                               warmup_cosine)

TARGETS = ["APA", "PAP"]


def _np_tree(rng, scale=1.0):
    """A parameter-shaped tree: matrices (decayed) and vectors (not)."""
    return {"layers": [{"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
                        "b": (rng.standard_normal(3) * scale).astype(np.float32)}],
            "head": {"w": (rng.standard_normal((3, 2)) * scale).astype(np.float32),
                     "q": (rng.standard_normal(4) * scale).astype(np.float32)}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(mine, ref, tol=1e-6):
    a, b = tree_leaves(mine), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=tol, atol=tol)


# ------------------------------------------------------------ optimizer --
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference_on_identical_grads(weight_decay):
    """Five AdamW steps on the same params and grads: params, moments and
    step within 1e-6; one grad leaf ``None`` counts as zeros."""
    rng = np.random.default_rng(0)
    p_np = _np_tree(rng)
    grads_np = [_np_tree(rng, 0.01) for _ in range(5)]
    p_ref, st_ref = jax.tree.map(jnp.asarray, p_np), ref_optim.adamw_init(p_np)
    p, st = _t(p_np), adamw_init(_t(p_np))
    for i, g in enumerate(grads_np):
        lr = 3e-3 * (i + 1) / 5
        gt = _t(g)
        if i == 2:  # the port's None grad is jax.grad's zeros
            g["head"]["q"] = np.zeros_like(g["head"]["q"])
            gt["head"]["q"] = None
        p_ref, st_ref = ref_optim.adamw_update(g, st_ref, p_ref, jnp.float32(lr),
                                               weight_decay=weight_decay)
        p, st = adamw_update(gt, st, p, torch.tensor(lr), weight_decay=weight_decay)
    _close(p, p_ref)
    _close(st.mu, st_ref.mu)
    _close(st.nu, st_ref.nu)
    assert st.step.dtype == torch.int32 and int(st.step) == int(st_ref.step) == 5


@pytest.mark.parametrize("max_norm", [0.05, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g_np = _np_tree(np.random.default_rng(1), 0.1)
    mine, gn = clip_by_global_norm(_t(g_np), max_norm)
    ref, gn_ref = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), max_norm)
    np.testing.assert_allclose(gn.item(), float(gn_ref), rtol=1e-6)
    _close(mine, ref)


def test_warmup_cosine_matches_reference():
    for base, warm, total in [(3e-3, 2, 20), (1e-2, 1, 5), (3e-3, 20, 200)]:
        mine, ref = warmup_cosine(base, warm, total), ref_optim.warmup_cosine(base, warm, total)
        for step in range(0, total + 3):
            got = mine(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), float(ref(jnp.int32(step))),
                                       rtol=1e-6, atol=1e-9)


# ------------------------------------------------------- masks, labels --
@pytest.fixture(scope="module")
def acm(acm_small):
    """The reference's and the port's ACM at scale 0.15 and frontends."""
    g_port = make_dataset("ACM", scale=0.15)
    ref_sess = ref_api.Session(ref_api.ExecutorSpec(na_executor="banded"))
    port_sess = Session(ExecutorSpec(device="cpu"))
    return {"ref_graph": acm_small, "ref_res": ref_sess.frontend(acm_small, TARGETS),
            "port_graph": g_port, "port_res": port_sess.frontend(g_port, TARGETS),
            "port_sess": port_sess}


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_and_labels_bitwise_equal_reference(acm, seed):
    n = acm["port_graph"].num_vertices["P"]
    mine = semi_supervised_masks(n, seed=seed, device="cpu")
    ref = ref_step.semi_supervised_masks(n, seed=seed)
    for k in ("train", "val", "test"):
        assert mine[k].dtype == torch.float32
        assert np.array_equal(mine[k].numpy(), np.asarray(ref[k]))
    sem, sem_ref = acm["port_res"].semantic, acm["ref_res"].semantic
    lab = propagated_feature_labels(sem, TARGETS, acm["port_graph"].features, n,
                                    seed=seed, device="cpu")
    lab_ref = ref_step.propagated_feature_labels(sem_ref, TARGETS,
                                                 acm["ref_graph"].features, n, seed=seed)
    assert lab.dtype == torch.int32 and np.array_equal(lab.numpy(), np.asarray(lab_ref))
    deg = degree_bucket_labels(sem, TARGETS, n, device="cpu")
    deg_ref = ref_step.degree_bucket_labels(sem_ref, TARGETS, n)
    assert np.array_equal(deg.numpy(), np.asarray(deg_ref))
    assert len(np.unique(lab.numpy())) == 3


# ---------------------------------------------------------- train step --
@pytest.mark.parametrize("executor", ["banded", "jnp"])
def test_train_step_trajectory_matches_reference(acm, executor):
    """Three steps from the same parameters: losses within 1e-4."""
    n = acm["port_graph"].num_vertices["P"]
    kw = dict(model="rgat", hidden=16, num_layers=2, target_type="P")
    ref_c = ref_api.Session(ref_api.ExecutorSpec(na_executor=executor)).compile(
        acm["ref_graph"], TARGETS, RefConfig(**kw))
    p_ref = ref_c.init(4)
    labels_ref = ref_step.propagated_feature_labels(
        acm["ref_res"].semantic, TARGETS, acm["ref_graph"].features, n)
    masks_ref = ref_step.semi_supervised_masks(n, seed=0)
    feats_ref = ref_api.device_features(acm["ref_graph"])
    step_ref = ref_step.make_train_step(ref_c.model, ref_c.graphs, warmup=1, total=3,
                                        executor=ref_c.spec)
    st_ref = ref_step.HGNNTrainState(params=p_ref, opt=ref_optim.adamw_init(p_ref))

    c = Session(ExecutorSpec(na_executor=executor, device="cpu")).compile(
        acm["port_graph"], TARGETS, HGNNConfig(**kw))
    st = train_state_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    labels = propagated_feature_labels(acm["port_res"].semantic, TARGETS,
                                       acm["port_graph"].features, n, device="cpu")
    masks = semi_supervised_masks(n, seed=0, device="cpu")
    feats = device_features(acm["port_graph"], "cpu")
    step = make_train_step(c.model, c.graphs, warmup=1, total=3, na_executor=executor)
    losses, losses_ref = [], []
    for _ in range(3):
        st_ref, l_ref = step_ref(st_ref, feats_ref, labels_ref, masks_ref["train"])
        st, loss = step(st, feats, labels, masks["train"])
        losses_ref.append(float(l_ref))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, losses_ref, atol=1e-4)
    assert losses[2] < losses[0]
    assert int(st.opt.step) == 3


# ------------------------------------------------------- fit, checkpoints --
def _fit_setup(acm):
    cfg = HGNNConfig(model="rgcn", num_classes=3, target_type="P", hidden=8, num_layers=2)
    compiled = acm["port_sess"].compile(acm["port_graph"], TARGETS, cfg)
    feats = device_features(acm["port_graph"], "cpu")
    labels = torch.from_numpy(np.random.default_rng(0).integers(
        0, 3, compiled.num_target).astype(np.int32))
    masks = semi_supervised_masks(compiled.num_target, seed=0, device="cpu")
    return compiled, feats, labels, masks


def test_hgnn_fit_checkpoints_and_resumes(tmp_path, acm):
    """``fit(ckpt_dir=...)`` saves every ``ckpt_every`` epochs; a rerun over
    the same directory resumes from the newest complete step and lands on
    the uninterrupted run's parameters."""
    compiled, feats, labels, masks = _fit_setup(acm)
    ref = compiled.fit(feats, labels, masks, epochs=6, seed=1)

    class _Interrupt(Exception):
        pass

    seen = []

    def crash_at_3(epoch, loss):
        seen.append(epoch)
        if epoch == 3:
            raise _Interrupt  # after the step-2 checkpoint, before step-4's

    with pytest.raises(_Interrupt):
        compiled.fit(feats, labels, masks, epochs=6, seed=1, ckpt_dir=str(tmp_path),
                     ckpt_every=2, epoch_callback=crash_at_3)
    assert seen == [0, 1, 2, 3]
    assert CheckpointManager(str(tmp_path)).steps() == [2]

    resumed = []
    out = compiled.fit(feats, labels, masks, epochs=6, seed=1, ckpt_dir=str(tmp_path),
                       ckpt_every=2, epoch_callback=lambda e, l: resumed.append(e))
    assert resumed == [2, 3, 4, 5]
    assert len(out["losses"]) == 6
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=2e-4, atol=2e-5)
    for a, b in zip(tree_leaves(ref["state"].params), tree_leaves(out["state"].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
    assert 0.0 <= out["val_acc"] <= 1.0 and out["losses"][-1] < out["losses"][0]


def test_hgnn_fit_resume_skips_crash_mid_save(tmp_path, acm):
    """A crash mid-save leaves a ``.tmp-`` dir or a manifest-less final
    dir; resume ignores both and the next save removes the first."""
    compiled, feats, labels, masks = _fit_setup(acm)

    def crash(epoch, loss):
        if epoch == 3:
            raise RuntimeError("crash")

    with pytest.raises(RuntimeError):
        compiled.fit(feats, labels, masks, epochs=6, seed=1, ckpt_dir=str(tmp_path),
                     ckpt_every=2, epoch_callback=crash)
    os.makedirs(tmp_path / "step_99.tmp-dead")
    (tmp_path / "step_99.tmp-dead" / "leaf_0.npy").write_bytes(b"junk")
    os.makedirs(tmp_path / "step_98")  # renamed, manifest never written
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    resumed = []
    out = compiled.fit(feats, labels, masks, epochs=6, seed=1, ckpt_dir=str(tmp_path),
                       ckpt_every=2, epoch_callback=lambda e, l: resumed.append(e))
    assert resumed == [2, 3, 4, 5] and len(out["losses"]) == 6
    assert not any(".tmp-" in d for d in os.listdir(tmp_path))


def test_checkpoint_keeps_the_newest_and_checks_structure(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    tree = {"b": torch.arange(3, dtype=torch.int32), "a": [torch.ones(2, 2)]}
    for s in (1, 2, 3):
        ck.save(s, tree, extra={"s": s})
    assert ck.steps() == [2, 3]
    step, back, extra = ck.restore_latest(tree)
    assert step == 3 and extra == {"s": 3}
    assert torch.equal(back["b"], tree["b"]) and back["b"].dtype == torch.int32
    with pytest.raises(ValueError, match="structure"):
        ck.restore(3, {"a": torch.ones(1)})
    leaves, _ = tree_flatten(HGNNTrainState(params={"z": 1, "y": 2},
                                            opt=AdamWState(step=3, mu=[4], nu=[5])))
    assert leaves == [2, 1, 3, 4, 5]  # jax.tree.flatten's order


def _ref_and_port_states(acm):
    cfg = dict(model="shgn", hidden=8, num_layers=2, target_type="P")
    ref_c = ref_api.Session(ref_api.ExecutorSpec()).compile(
        acm["ref_graph"], TARGETS, RefConfig(**cfg))
    p_ref = ref_c.init(5)
    st_ref = ref_step.HGNNTrainState(params=p_ref, opt=ref_optim.adamw_init(p_ref))
    # give the moments and the step values of their own
    st_ref.opt.mu = jax.tree.map(lambda x: x + 0.5, st_ref.opt.mu)
    st_ref.opt.nu = jax.tree.map(lambda x: x + 0.25, st_ref.opt.nu)
    st_ref.opt.step = jnp.int32(7)
    c = acm["port_sess"].compile(acm["port_graph"], TARGETS, HGNNConfig(**cfg))
    st = HGNNTrainState(params=c.init(6), opt=adamw_init(c.init(6)))
    return st_ref, st


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path, acm):
    st_ref, like = _ref_and_port_states(acm)
    RefCheckpoints(str(tmp_path)).save(4, st_ref, extra={"epoch": 4, "losses": [1.5]})
    step, st, extra = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 4 and extra == {"epoch": 4, "losses": [1.5]}
    assert isinstance(st, HGNNTrainState) and isinstance(st.opt, AdamWState)
    ref_leaves = jax.tree.leaves(st_ref)
    mine = tree_leaves(st)
    assert len(mine) == len(ref_leaves)
    for a, b in zip(mine, ref_leaves):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    assert st.opt.step.dtype == torch.int32 and int(st.opt.step) == 7


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path, acm):
    like_ref, st = _ref_and_port_states(acm)
    st.opt.step = torch.tensor(9, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(2, st, extra={"epoch": 2, "losses": [1.0, 0.9]})
    step, back, extra = RefCheckpoints(str(tmp_path)).restore_latest(like_ref)
    assert step == 2 and extra["losses"] == [1.0, 0.9]
    ref_leaves = jax.tree.leaves(back)
    mine = tree_leaves(st)
    assert len(ref_leaves) == len(mine)
    for a, b in zip(mine, ref_leaves):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    # and the reference's train step runs on what it restored
    assert int(back.opt.step) == 9


def test_session_loss_and_evaluate_match_reference(acm):
    n = acm["port_graph"].num_vertices["P"]
    kw = dict(model="rgcn", hidden=16, num_layers=2, target_type="P")
    ref_c = ref_api.Session(ref_api.ExecutorSpec(na_executor="jnp")).compile(
        acm["ref_graph"], TARGETS, RefConfig(**kw))
    p_ref = ref_c.init(1)
    labels_np = np.random.default_rng(3).integers(0, 3, n).astype(np.int32)
    mask_np = (np.arange(n) % 2).astype(np.float32)
    feats_ref = ref_api.device_features(acm["ref_graph"])
    c = Session(ExecutorSpec(na_executor="jnp", device="cpu")).compile(
        acm["port_graph"], TARGETS, HGNNConfig(**kw))
    p = train_state_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu").params
    feats = device_features(acm["port_graph"], "cpu")
    labels, mask = torch.from_numpy(labels_np), torch.from_numpy(mask_np)
    for m_ref, m in ((None, None), (jnp.asarray(mask_np), mask)):
        np.testing.assert_allclose(
            c.loss(p, feats, labels, m).item(),
            float(ref_c.loss(p_ref, feats_ref, jnp.asarray(labels_np), m_ref)), atol=1e-5)
        assert c.evaluate(p, feats, labels, m).item() == pytest.approx(
            float(ref_c.evaluate(p_ref, feats_ref, jnp.asarray(labels_np), m_ref)), abs=1e-6)
    assert c.loss(p, feats, labels).requires_grad is False  # plain params, no grad
