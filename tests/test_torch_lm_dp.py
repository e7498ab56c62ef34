"""The port's LM train step over several data ranks on the CPU.

The reference's ``build_train_step`` is one GSPMD program: whatever the
mesh, a step gives the loss and gradients of the whole global batch.  The
data-parallel step over ``(2, 1)``, ``(4, 1)`` and ``(2, 2, 1)`` (pods)
CPU meshes is held here to the port's one-rank step on the same global
batch (the loss within 1e-5, the first and second moments within
``GRAD_RTOL`` of each leaf's largest entry), and in
``test_torch_lm_dp_reference.py`` to the reference's step body.  Also: bitwise repeats, the MoE aux over all
ranks' tokens (the mean of per-rank aux values misses), the misaligned
MoE-group refusal, ``ElasticController`` from 4 ranks to 2 and
``FaultTolerantRunner`` restoring a data-parallel run bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh_for  # noqa: E402
from repro_torch.models.layers import moe_aux  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import (CheckpointManager, SyntheticTokens,  # noqa: E402
                               tree_leaves)
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train._lm_pspecs import data_pspec  # noqa: E402
from repro_torch.train.fault_tolerance import (ElasticController,  # noqa: E402
                                               FaultTolerantRunner)
from repro_torch.train.train_step import build_train_step, init_train_state  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these many small steps: under the suite's
    parallel workers a thread pool a process oversubscribes the cores and
    each small op waits on its pool (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH, LR = 8, 1e-3
LOSS_TOL = 1e-5
GRAD_RTOL = 5e-2  # as test_torch_lm_train_stack.py: bf16 gradients round per rank
# reduced configs route MoE tokens in groups of 64 (configs.reduced), so one
# row of 64 a rank fills a group on 4 ranks with 2 microbatches
SEQ = {"smollm-135m": 32, "mamba2-370m": 32, "granite-moe-1b-a400m": 64}
MESHES = {"2x1": ((2, 1), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "pods 2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _mesh(key):
    shape, axes = MESHES[key]
    return make_mesh_for([CPU] * int(np.prod(shape)), shard_axes=axes, shape=shape)


def _model(name):
    cfg = configs.reduced(configs.get_config(name))
    return cfg, LM(cfg, device="cpu", remat="full", ssd_chunk=8)


def _max_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / a.float().abs().max().clamp(min=1e-30))


def _assert_matches(one, m1, dp, m2):
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= LOSS_TOL
    for a, b in zip(tree_leaves((one.opt.mu, one.opt.nu)), tree_leaves((dp.opt.mu, dp.opt.nu))):
        assert _max_rel(a, b) <= GRAD_RTOL
    assert int(dp.opt.step) == int(one.opt.step)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SEQ))
def test_data_parallel_step_equals_the_one_rank_step(name, mesh_key, microbatches):
    """The per-rank batches of ``sharded_batch`` through the data-parallel
    step against one (B, S) batch through the one-rank step, from one
    state; mamba2 through K5's plain version, granite-moe with its aux."""
    cfg, model = _model(name)
    mesh = _mesh(mesh_key)
    data = SyntheticTokens(cfg.vocab_size, SEQ[name], BATCH)
    state = init_train_state(model, 0)
    one_fn, _ = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), BATCH, lr=LR,
                                 microbatches=microbatches)
    one, m1 = one_fn(state, *(torch.from_numpy(a) for a in data.host_batch(0)))
    dp_fn, _ = build_train_step(model, mesh, BATCH, lr=LR, microbatches=microbatches)
    dp, m2 = dp_fn(state, data.sharded_batch(0, mesh, data_pspec(mesh, BATCH)))
    _assert_matches(one, m1, dp, m2)


def test_data_parallel_step_takes_one_batch_tensor_and_repeats_bitwise():
    """An unsharded (B, S) batch gives the sharded batch's step bit for bit,
    and the rank-order sums repeat bit for bit."""
    cfg, model = _model("granite-moe-1b-a400m")
    mesh = _mesh("4x1")
    data = SyntheticTokens(cfg.vocab_size, SEQ[cfg.name], BATCH)
    state = init_train_state(model, 0)
    fn, _ = build_train_step(model, mesh, BATCH, lr=LR, microbatches=2)
    a, ma = fn(state, data.sharded_batch(0, mesh, data_pspec(mesh, BATCH)))
    b, mb = fn(state, *(torch.from_numpy(x) for x in data.host_batch(0)))
    c, mc = fn(state, data.sharded_batch(0, mesh, data_pspec(mesh, BATCH)))
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["loss"], mc["loss"])


def test_moe_aux_is_formed_over_every_rank(monkeypatch):
    """The router's gradient needs the aux of the whole microbatch: with
    each rank's own aux averaged instead (a planted fault), the router
    leaves' first moments miss the one-rank step's by more than the
    correct step does."""
    cfg, model = _model("granite-moe-1b-a400m")
    mesh = _mesh("4x1")
    data = SyntheticTokens(cfg.vocab_size, SEQ[cfg.name], BATCH)
    state = init_train_state(model, 0)
    one_fn, _ = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), BATCH, lr=LR)
    one, m1 = one_fn(state, *(torch.from_numpy(a) for a in data.host_batch(0)))
    dp_fn, _ = build_train_step(model, mesh, BATCH, lr=LR)
    shards = data.sharded_batch(0, mesh, data_pspec(mesh, BATCH))
    good, mg = dp_fn(state, shards)
    monkeypatch.setattr(ts, "aux_share",
                        lambda own, top1, n: sum(moe_aux(m, f) for m, f in own) / n)
    bad, mbad = dp_fn(state, shards)

    def router(s):
        return [blk["ffn"]["w_router"] for blk in s.opt.mu["blocks"] if "w_router" in blk["ffn"]]

    good_rel = max(_max_rel(a, b) for a, b in zip(router(one), router(good)))
    bad_rel = max(_max_rel(a, b) for a, b in zip(router(one), router(bad)))
    assert good_rel <= GRAD_RTOL < bad_rel
    assert abs(float(m1["loss"]) - float(mg["loss"])) <= LOSS_TOL
    assert abs(float(m1["loss"]) - float(mbad["loss"])) > LOSS_TOL


def test_misaligned_moe_groups_raise():
    """A rank whose tokens do not fill whole routing groups would route
    unlike the one-rank forward: the step refuses and names it."""
    cfg, model = _model("granite-moe-1b-a400m")
    mesh = _mesh("4x1")
    data = SyntheticTokens(cfg.vocab_size, 32, BATCH)  # 32 tokens a rank, groups of 64
    fn, _ = build_train_step(model, mesh, BATCH, lr=LR, microbatches=2)
    with pytest.raises(ValueError, match="MoE routing groups"):
        fn(init_train_state(model, 0), data.sharded_batch(0, mesh, data_pspec(mesh, BATCH)))
    with pytest.raises(ValueError, match="data ranks"):
        build_train_step(model, mesh, 4, microbatches=2)


def test_elastic_controller_from_four_ranks_to_two(monkeypatch):
    """A run on 4 data ranks loses 2: ``make_mesh`` builds the (2, 1) mesh,
    ``reshard`` places the state where its step expects it, and each step,
    on 4 ranks and then on 2, equals the one-rank step from its state."""
    monkeypatch.setenv("REPRO_TORCH_VIRTUAL_DEVICES", "4")
    cfg, model = _model("smollm-135m")
    data = SyntheticTokens(cfg.vocab_size, SEQ[cfg.name], BATCH)
    ec = ElasticController(device="cpu")
    one_fn, _ = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), BATCH, lr=LR)
    state = init_train_state(model, 0)
    for i, n in enumerate((4, 2)):
        mesh = ec.make_mesh(n)
        assert dict(mesh.shape) == {"data": n, "model": 1}
        fn, specs = build_train_step(model, mesh, BATCH, lr=LR)
        state = ec.reshard(state, mesh, specs)
        assert all(x.device == mesh.ranks[0] for x in tree_leaves(state))
        one, m1 = one_fn(state, *(torch.from_numpy(a) for a in data.host_batch(i)))
        state, m2 = fn(state, data.sharded_batch(i, mesh, data_pspec(mesh, BATCH)))
        _assert_matches(one, m1, state, m2)


def test_fault_tolerant_runner_restores_a_data_parallel_run(tmp_path):
    """A fault after the step-2 checkpoint of a (2, 1) run: the restored run
    replays the same per-rank batches and ends bitwise on the uninterrupted
    run's state."""
    cfg, model = _model("smollm-135m")
    mesh = _mesh("2x1")
    data = SyntheticTokens(cfg.vocab_size, SEQ[cfg.name], BATCH)
    state0 = init_train_state(model, 0)
    fn, specs = build_train_step(model, mesh, BATCH, lr=LR, microbatches=2)

    def data_fn(step):
        return data.sharded_batch(step % 2, mesh, data_pspec(mesh, BATCH)), None

    clean, _ = FaultTolerantRunner(fn, data_fn, CheckpointManager(str(tmp_path / "a")),
                                   ckpt_every=2).run(state0, 0, 5, specs=specs, mesh=mesh)
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    resumed, stats = FaultTolerantRunner(fn, data_fn, CheckpointManager(str(tmp_path / "b")),
                                         ckpt_every=2, fault_hook=hook).run(
        state0, 0, 5, specs=specs, mesh=mesh)
    assert stats.failures == 1 and stats.restores == 1
    for a, b in zip(tree_leaves(clean), tree_leaves(resumed)):
        assert torch.equal(a, b)
