"""The port's LM training stack on the CPU against the JAX package's:
``build_train_step`` against the reference's step body composed from its
own pieces (``jax.value_and_grad`` of ``LM.loss``, microbatch accumulation,
``clip_by_global_norm``, ``compress_decompress``, ``adamw_update``; its
``build_train_step`` itself fails to build on this JAX), ``SyntheticTokens``
bitwise, the partition specs tuple for tuple, the LM meshes, the runner,
the straggler watchdog, elastic resharding, and ``TrainState`` checkpoints
crossing between the packages bitwise (bf16 leaves included).  The
reference's own LM cases (``tests/test_train.py``) have counterparts here.
"""
import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.train._lm_pspecs as ref_pspecs  # noqa: E402
import repro.train.compress as ref_compress  # noqa: E402
import repro.train.optim as ref_optim  # noqa: E402
from repro.launch.mesh import _balanced_shape as ref_balanced_shape  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RefCheckpoints  # noqa: E402
from repro.train.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.train.train_step import TrainState as RefTrainState  # noqa: E402
from repro.train.train_step import state_pspecs as ref_state_pspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh_for  # noqa: E402
from repro_torch.models.lm import LM, init_params, lm_params_from_numpy  # noqa: E402
from repro_torch.train import (CheckpointManager, SyntheticTokens,  # noqa: E402
                               adamw_init, tree_leaves, tree_map)
from repro_torch.train import _lm_pspecs as port_pspecs  # noqa: E402
from repro_torch.train.checkpoint import spec_repr  # noqa: E402
from repro_torch.train.compress import (compress_decompress,  # noqa: E402
                                        compressed_bytes, init_residuals)
from repro_torch.train.fault_tolerance import (ElasticController,  # noqa: E402
                                               FaultTolerantRunner)
from repro_torch.train.train_step import (TrainState, build_train_step,  # noqa: E402
                                          init_train_state, state_pspecs)
from repro_torch.train.tree import flatten_up_to, tree_flatten  # noqa: E402

NAME = "smollm-135m"
BATCH, SEQ, STEPS, LR = 4, 32, 3, 1e-3
LOSS_TOL = 1e-3  # as tests/test_torch_lm_train.py: bf16 layers round at other places
GRAD_RTOL = 5e-2  # gradient-derived leaves (moments), of each leaf's largest entry


def _reduced():
    cfg = ref_configs.reduced(ref_configs.ARCHS[NAME])
    ref = RefLM(cfg, backend="jnp", remat="none")
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(NAME)), device="cpu", remat="full")
    return cfg, ref, rp, port


def _ref_step(ref, microbatches, use_compression, lr):
    """The body of the reference's ``build_train_step.step``
    (``repro/train/train_step.py:91-134``) without the mesh: the same
    pieces in the same order, the microbatch scan as a loop."""
    def loss_fn(params, tok, tgt):
        return ref.loss(params, tok, tgt, aux_weight=0.01)

    vg = jax.jit(jax.value_and_grad(loss_fn))

    def step(params, opt, residuals, tok, tgt):
        if microbatches == 1:
            loss, grads = vg(params, tok, tgt)
        else:
            rows = tok.shape[0] // microbatches
            loss = jnp.zeros(())
            grads = jax.tree.map(lambda p: jnp.zeros(jnp.shape(p), jnp.float32), params)
            for i in range(microbatches):
                sl = slice(i * rows, (i + 1) * rows)
                l_i, g_i = vg(params, tok[sl], tgt[sl])
                loss = loss + l_i
                grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), grads, g_i)
            loss = loss / microbatches
            grads = jax.tree.map(lambda g: g / microbatches, grads)
        grads, gnorm = ref_optim.clip_by_global_norm(grads, 1.0)
        if use_compression:
            grads, residuals = ref_compress.compress_decompress(grads, residuals)
        params, opt = ref_optim.adamw_update(grads, opt, params, lr)
        return params, opt, residuals, loss, gnorm

    return step


def _max_rel(a, b) -> float:
    a32, b32 = np.asarray(a, np.float32), b.float().numpy()
    return float(np.abs(a32 - b32).max() / max(np.abs(a32).max(), 1e-30))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference_pieces(microbatches, compress):
    """Three steps from the same parameters on the same batches: the loss
    and global norm of each step, and after the last the parameters (each
    entry within STEPS x 2 lr + 2^-7 |p|: AdamW moves an entry by about lr
    a step in its gradient's direction, so an entry whose gradient is near
    0 may move the other way on the other side, and each side rounds it to
    bf16) and the first and second moments (within GRAD_RTOL of each
    leaf's largest entry)."""
    cfg, ref, rp, port = _reduced()
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    state = TrainState(params=pp, opt=adamw_init(pp),
                       residuals=init_residuals(pp) if compress else None)
    step_fn, specs = build_train_step(port, make_debug_mesh(1, 1, device="cpu"), BATCH,
                                      lr=LR, microbatches=microbatches,
                                      use_compression=compress)
    assert isinstance(specs, TrainState)
    ref_step = _ref_step(ref, microbatches, compress, LR)
    r_params, r_opt = rp, ref_optim.adamw_init(rp)
    r_res = ref_compress.init_residuals(rp) if compress else None
    data = SyntheticTokens(cfg.vocab_size, SEQ, BATCH)
    for i in range(STEPS):
        tok, tgt = data.host_batch(i)
        state, m = step_fn(state, torch.from_numpy(tok), torch.from_numpy(tgt))
        r_params, r_opt, r_res, r_loss, r_norm = ref_step(
            r_params, r_opt, r_res, jnp.asarray(tok), jnp.asarray(tgt))
        assert abs(float(m["loss"]) - float(r_loss)) <= LOSS_TOL, (i, float(m["loss"]))
        assert abs(float(m["grad_norm"]) / float(r_norm) - 1) <= GRAD_RTOL
        assert float(m["lr"]) == pytest.approx(LR)
    assert int(state.opt.step) == STEPS
    for a, b in zip(jax.tree.leaves(r_params), tree_leaves(state.params)):
        a32, b32 = np.asarray(a, np.float32), b.float().numpy()
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert (np.abs(a32 - b32) <= STEPS * 2 * LR + 2 ** -7 * np.abs(a32)).all()
    for a, b in zip(jax.tree.leaves((r_opt.mu, r_opt.nu)),
                    tree_leaves((state.opt.mu, state.opt.nu))):
        assert _max_rel(a, b) <= GRAD_RTOL
    if compress:  # residuals: each within one quantization step of the reference's
        for a, b in zip(jax.tree.leaves(r_res), tree_leaves(state.residuals)):
            assert b.dtype == torch.float32 and float(b.abs().max()) > 0
            a32 = np.asarray(a)
            assert np.abs(a32 - b.numpy()).max() <= 2.05 * np.abs(a32).max() + 1e-12
    else:
        assert state.residuals is None


def test_microbatches_split_the_rows_in_order():
    """2 microbatches of 2 rows give one batch of 4's loss, and gradients
    within GRAD_RTOL (each microbatch's bf16 gradient rounds on its own)."""
    cfg, _, _, port = _reduced()
    mesh = make_debug_mesh(1, 1, device="cpu")
    tok, tgt = (torch.from_numpy(a) for a in SyntheticTokens(cfg.vocab_size, SEQ,
                                                               BATCH).host_batch(0))
    outs = []
    for mb in (1, 2):
        fn, _ = build_train_step(port, mesh, BATCH, lr=LR, microbatches=mb)
        outs.append(fn(init_train_state(port, 0), tok, tgt))
    (one, m1), (two, m2) = outs
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    for a, b in zip(tree_leaves(one.opt.mu), tree_leaves(two.opt.mu)):
        assert float((a - b).abs().max()) <= GRAD_RTOL * float(a.abs().max())
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(port, mesh, BATCH, microbatches=3)


def test_mesh_with_more_than_one_data_rank_raises():
    """Data parallelism over ranks is the next slice: a (2, 1) mesh raises
    and names it; a (1, 2) mesh of ranks on one device runs."""
    _, _, _, port = _reduced()
    cpu = torch.device("cpu")
    mesh = make_mesh_for([cpu, cpu], shard_axes=("data", "model"), shape=(2, 1))
    with pytest.raises(NotImplementedError, match="slice 14"):
        build_train_step(port, mesh, BATCH)
    pods = make_mesh_for([cpu, cpu], shard_axes=("pod", "data", "model"), shape=(2, 1, 1))
    with pytest.raises(NotImplementedError, match="slice 14"):
        build_train_step(port, pods, BATCH)
    fn, specs = build_train_step(
        port, make_mesh_for([cpu, cpu], shard_axes=("data", "model"), shape=(1, 2)), BATCH)
    assert specs.params["embed"] == ("model", None)


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 16, 8, 3), (49152, 64, 4, 0),
                                                  (50, 7, 3, 11)])
def test_synthetic_tokens_are_bitwise_the_reference(vocab, seq, batch, seed):
    mine, ref = SyntheticTokens(vocab, seq, batch, seed), RefTokens(vocab, seq, batch, seed)
    for step in (0, 1, 5, 1 << 40):
        a, b = mine.host_batch(step), ref.host_batch(step)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    tok, tgt = mine.host_batch(7)
    np.testing.assert_array_equal(tok[:, 1:], tgt[:, :-1])


@pytest.mark.parametrize("shape,axes", [((4, 1), ("data", "model")),
                                        ((2, 2), ("data", "model")),
                                        ((2, 2, 1), ("pod", "data", "model"))])
def test_sharded_batch_builds_each_rank_from_its_rows(shape, axes):
    """Each data rank's rows from those rows alone, on its rank, in rank
    order: concatenated, bitwise ``host_batch`` (and the reference's
    ``sharded_batch`` on its one-device mesh)."""
    data = SyntheticTokens(1000, 16, 8, seed=3)
    n = int(np.prod(shape))
    mesh = make_mesh_for([torch.device("cpu")] * n, shard_axes=axes, shape=shape)
    spec = port_pspecs.data_pspec(mesh, 8)
    parts = data.sharded_batch(5, mesh, spec)
    assert len(parts) == port_pspecs.data_ranks(mesh, spec) == int(
        np.prod([mesh.shape[a] for a in axes if a != "model"]))
    want = data.host_batch(5)
    for got, w in zip((torch.cat([p[i] for p in parts]) for i in (0, 1)), want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), w)
    ref_tok, ref_tgt = RefTokens(1000, 16, 8, seed=3).sharded_batch(
        5, jax.make_mesh((1, 1), ("data", "model")), P("data", None))
    np.testing.assert_array_equal(np.asarray(ref_tok), want[0])
    np.testing.assert_array_equal(np.asarray(ref_tgt), want[1])


# -------------------------------------------------------------- pspecs --
def _fake_mesh(shape: dict):
    """What the reference's spec functions read of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _port_mesh(shape: dict):
    return make_mesh_for([torch.device("cpu")] * int(np.prod(list(shape.values()))),
                         shard_axes=tuple(shape), shape=tuple(shape.values()))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", sorted(ref_configs.ARCHS))
def test_param_and_state_pspecs_equal_the_reference(name, reduced):
    """Every leaf's spec is ``tuple(P)`` of the reference's, for the full
    and reduced config at model axes of 1, 4 and 16 (shapes from the
    reference's ``eval_shape`` and the port's init on the meta device)."""
    rcfg = ref_configs.ARCHS[name]
    pcfg = configs.get_config(name)
    if reduced:
        rcfg, pcfg = ref_configs.reduced(rcfg), configs.reduced(pcfg)
    shapes = jax.eval_shape(RefLM(rcfg).init, jax.random.key(0))
    meta = init_params(0, pcfg, device="meta")
    for m in (1, 4, 16):
        want = ref_pspecs.param_pspecs(rcfg, shapes, model_axis_size=m)
        got = port_pspecs.param_pspecs(pcfg, meta, model_axis_size=m)
        w_leaves = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))
        g_leaves = flatten_up_to(tree_flatten(meta)[1], got)
        assert [tuple(s) for s in w_leaves] == g_leaves
    ref_state = RefTrainState(params=shapes, opt=jax.eval_shape(ref_optim.adamw_init, shapes),
                              residuals=None)
    port_state = TrainState(params=meta, opt=adamw_init(meta), residuals=None)
    want = ref_state_pspecs(rcfg, ref_state, model_axis_size=4)
    got = state_pspecs(pcfg, port_state, model_axis_size=4)
    assert tuple(want.opt.step) == got.opt.step == ()
    assert got.residuals is None


@pytest.mark.parametrize("shape", [{"data": 1, "model": 1}, {"data": 4, "model": 4},
                                   {"data": 3, "model": 2}, {"pod": 2, "data": 4, "model": 2},
                                   {"pod": 2, "data": 3, "model": 1}])
@pytest.mark.parametrize("batch", [1, 4, 6, 8])
def test_data_and_cache_pspecs_equal_the_reference(shape, batch):
    assert tuple(ref_pspecs.data_pspec(_fake_mesh(shape), batch)) == \
        port_pspecs.data_pspec(_port_mesh(shape), batch)
    for name in ("smollm-135m", "mamba2-370m", "minicpm3-4b", "jamba-v0.1-52b"):
        rcfg = ref_configs.reduced(ref_configs.ARCHS[name])
        pcfg = configs.reduced(configs.get_config(name))
        cache = jax.eval_shape(lambda: RefLM(rcfg).init_cache(batch, 16))
        want = ref_pspecs.cache_pspecs(rcfg, cache, _fake_mesh(shape), batch)
        got = port_pspecs.cache_pspecs(pcfg, LM(pcfg, device="meta").init_cache(batch, 16),
                                       _port_mesh(shape), batch)
        assert [{k: tuple(v) for k, v in c.items()} for c in want] == got


def test_shard_params_places_every_leaf_on_the_first_rank():
    cfg = configs.reduced(configs.get_config(NAME))
    params = LM(cfg, device="cpu").init(0)
    mesh = _port_mesh({"data": 2, "model": 2})
    placed = port_pspecs.shard_params(params, mesh,
                                      port_pspecs.param_pspecs(cfg, params, model_axis_size=2))
    for a, b in zip(tree_leaves(params), tree_leaves(placed)):
        assert torch.equal(a, b) and b.device == mesh.ranks[0]


def test_moved_names_raise_with_a_pointer():
    import repro_torch.distributed as dist

    for name in ("param_pspecs", "data_pspec", "cache_pspecs", "shard_params"):
        with pytest.raises(ImportError, match="_lm_pspecs"):
            getattr(dist, name)
    with pytest.raises(AttributeError):
        dist.no_such_name  # noqa: B018


# --------------------------------------------------------------- meshes --
@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_lm_meshes_size_from_the_ranks(monkeypatch, n):
    monkeypatch.setenv(port_mesh.VIRTUAL_DEVICES_ENV, str(n))
    mesh = port_mesh.make_production_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert tuple(mesh.shape.values()) == ref_balanced_shape(n, 2)
    if n % 2:
        with pytest.raises(ValueError, match="even"):
            port_mesh.make_production_mesh(multi_pod=True, device="cpu")
    else:
        pods = port_mesh.make_production_mesh(multi_pod=True, device="cpu")
        assert pods.axis_names == ("pod", "data", "model")
        assert tuple(pods.shape.values()) == (2,) + ref_balanced_shape(n // 2, 2)
    debug = make_debug_mesh(1, 1, device="cpu")
    assert dict(debug.shape) == {"data": 1, "model": 1}
    if n >= 2:
        assert tuple(make_debug_mesh(n // 2, 2, device="cpu").shape.values()) == (n // 2, 2)
    with pytest.raises(ValueError):
        make_debug_mesh(n + 1, 1, device="cpu")


# ----------------------------------------- the reference's LM train cases --
def _setup(compress=False):
    cfg = configs.reduced(configs.get_config(NAME))
    model = LM(cfg, device="cpu", remat="none")
    state = init_train_state(model, 0, use_compression=compress)
    step_fn, specs = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), 4,
                                      lr=1e-3, use_compression=compress)
    return cfg, model, state, step_fn, specs, SyntheticTokens(cfg.vocab_size, 32, 4)


def _batch(data, step):
    return tuple(torch.from_numpy(a) for a in data.host_batch(step))


@pytest.mark.parametrize("compress", [False, True])
def test_train_loss_decreases(compress):
    """``test_train_loss_decreases`` and
    ``test_compressed_training_still_converges`` of the reference."""
    _, _, state, step_fn, _, data = _setup(compress)
    losses = []
    for step in range(12):
        state, m = step_fn(state, *_batch(data, step % 2))  # small repeating stream
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_checkpoint_roundtrip_and_gc(tmp_path):
    _, _, state, step_fn, specs, data = _setup()
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    state, _ = step_fn(state, *_batch(data, 0))
    ckpt.save(1, state, specs=specs, extra={"note": "s1"})
    restored, extra = ckpt.restore(1, state)
    assert extra["note"] == "s1"
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert "bfloat16" in manifest["dtypes"]
    assert "PartitionSpec('model', None)" in manifest["specs"]
    ckpt.save(2, state)
    ckpt.save(3, state)
    assert ckpt.steps() == [2, 3]  # keep=2 garbage-collected step 1


def test_restore_onto_a_mesh_places_leaves_on_the_first_rank(tmp_path):
    _, _, state, _, specs, _ = _setup()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(4, state, specs=specs)
    mesh = _port_mesh({"data": 1, "model": 2})
    step, restored, _ = ckpt.restore_latest(state, mesh=mesh, specs=specs)
    assert step == 4
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b) and b.device == mesh.ranks[0]


def test_fault_tolerant_runner_restores(tmp_path):
    _, _, state, step_fn, _, data = _setup()
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    boom = {"armed": True}

    def fault_hook(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device failure")

    runner = FaultTolerantRunner(step_fn, lambda s: _batch(data, s), ckpt, ckpt_every=5,
                                 fault_hook=fault_hook)
    state, stats = runner.run(state, 0, 10)
    assert stats.failures == 1
    assert stats.restores == 1  # restored from the step-5 checkpoint
    assert stats.steps_done >= 10
    assert np.isfinite(stats.last_loss)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """A fault after the step-2 checkpoint: the restored run replays the
    same batches and ends on the uninterrupted run's parameters, bitwise."""
    _, _, state0, step_fn, _, data = _setup()
    clean, _ = FaultTolerantRunner(step_fn, lambda s: _batch(data, s % 2),
                                   CheckpointManager(str(tmp_path / "a")),
                                   ckpt_every=2).run(state0, 0, 5)
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    resumed, stats = FaultTolerantRunner(step_fn, lambda s: _batch(data, s % 2),
                                         CheckpointManager(str(tmp_path / "b")),
                                         ckpt_every=2, fault_hook=hook).run(state0, 0, 5)
    assert stats.restores == 1
    for a, b in zip(tree_leaves(clean), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_non_finite_loss_fails_the_step(tmp_path):
    calls = []

    def step_fn(state, tok, tgt):
        calls.append(1)
        return state, {"loss": torch.tensor(float("nan"))}

    runner = FaultTolerantRunner(step_fn, lambda s: (None, None),
                                 CheckpointManager(str(tmp_path)), max_retries=2)
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.run({"p": torch.zeros(())}, 0, 3)
    assert len(calls) == 3 and runner.stats.failures == 3


def test_straggler_watchdog(tmp_path):
    calls = []

    def step_fn(state, tok, tgt):
        calls.append(1)
        time.sleep(0.35 if len(calls) == 6 else 0.05)  # the 6th call: about 7x the EWMA
        return state, {"loss": torch.tensor(1.0)}

    stragglers = []
    runner = FaultTolerantRunner(step_fn, lambda s: (None, None),
                                 CheckpointManager(str(tmp_path)), ckpt_every=100,
                                 straggler_factor=3.0,
                                 on_straggler=lambda s, dt: stragglers.append(s))
    runner.run({"p": torch.zeros(())}, 0, 8)
    assert stragglers == [5]


def test_compression_error_feedback_matches_the_reference():
    """int8 error feedback on identical inputs: decompressed gradients and
    residuals within float32 rounding of the reference's, the accumulated
    signal faithful (the reference's test), and the byte counts."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(256).astype(np.float32), \
        (rng.standard_normal((64, 8)) * 5).astype(np.float32)
    ref_g, mine_g = {"a": jnp.asarray(a), "b": jnp.asarray(b)}, \
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    r_ref, r_mine = ref_compress.init_residuals(ref_g), init_residuals(mine_g)
    acc_true = {k: np.zeros_like(v.numpy()) for k, v in mine_g.items()}
    acc_comp = {k: np.zeros_like(v.numpy()) for k, v in mine_g.items()}
    for i in range(20):
        gr = jax.tree.map(lambda x: x * (1 + 0.01 * i), ref_g)
        gm = tree_map(lambda x: x * (1 + 0.01 * i), mine_g)
        d_ref, r_ref = ref_compress.compress_decompress(gr, r_ref)
        d_mine, r_mine = compress_decompress(gm, r_mine)
        for k in ("a", "b"):
            np.testing.assert_allclose(d_mine[k].numpy(), np.asarray(d_ref[k]), atol=1e-5)
            np.testing.assert_allclose(r_mine[k].numpy(), np.asarray(r_ref[k]), atol=1e-5)
            acc_true[k] += gm[k].numpy()
            acc_comp[k] += d_mine[k].numpy()
    for k in ("a", "b"):
        assert np.abs(acc_true[k] - acc_comp[k]).max() < 0.05 * np.abs(acc_true[k]).max()
    assert compressed_bytes(mine_g) == ref_compress.compressed_bytes(ref_g)


def test_elastic_reshard():
    ec = ElasticController(device="cpu")
    mesh1 = ec.make_mesh(1, model_parallel=1)
    assert mesh1.axis_names == ("data", "model") and dict(mesh1.shape) == {"data": 1, "model": 1}
    tree = {"w": torch.arange(16.0).reshape(4, 4), "e": torch.ones(3, dtype=torch.bfloat16)}
    out = ec.reshard(tree, mesh1, {"w": (None, None), "e": ("model",)})
    for k in tree:
        assert torch.equal(out[k], tree[k]) and out[k].device == mesh1.ranks[0]
    with pytest.raises(ValueError):
        ec.make_mesh(3, model_parallel=2)


# ------------------------------------------------ checkpoints, crossing --
def _ref_state(compress):
    cfg = ref_configs.reduced(ref_configs.ARCHS["granite-moe-1b-a400m"])
    rp = RefLM(cfg).init(jax.random.key(0))
    opt = ref_optim.adamw_init(rp)
    # one optimizer step so that no leaf is a constant
    g = jax.tree.map(lambda p: jnp.full(jnp.shape(p), 0.5, p.dtype), rp)
    rp, opt = ref_optim.adamw_update(g, opt, rp, 1e-2)
    res = ref_compress.init_residuals(rp) if compress else None
    if compress:
        res = jax.tree.map(lambda r: r + 0.25, res)
    return cfg, RefTrainState(params=rp, opt=opt, residuals=res)


def _port_like(ref_state):
    """A port ``TrainState`` with the reference's structure (zeros)."""
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_state.params), "cpu")
    return tree_map(torch.zeros_like, TrainState(
        params=params, opt=adamw_init(params),
        residuals=None if ref_state.residuals is None else init_residuals(params)))


def _bitwise(ref_leaves, port_leaves):
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        a = np.asarray(a)
        assert a.dtype.name == str(b.dtype).replace("torch.", "")
        if a.dtype.name == "bfloat16":
            assert np.array_equal(a.view(np.uint16), b.view(torch.uint16).numpy())
        else:
            assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("compress", [False, True])
def test_reference_lm_checkpoint_restores_bitwise_in_the_port(tmp_path, compress):
    cfg, rstate = _ref_state(compress)
    specs = ref_state_pspecs(cfg, rstate, model_axis_size=1)
    RefCheckpoints(str(tmp_path)).save(3, rstate, specs=specs, extra={"step": 3})
    step, got, extra = CheckpointManager(str(tmp_path)).restore_latest(_port_like(rstate))
    assert step == 3 and extra == {"step": 3}
    assert isinstance(got, TrainState) and (got.residuals is None) == (not compress)
    _bitwise(jax.tree.leaves(rstate), tree_leaves(got))


@pytest.mark.parametrize("compress", [False, True])
def test_port_lm_checkpoint_restores_bitwise_in_the_reference(tmp_path, compress):
    cfg, rstate = _ref_state(compress)
    mine = tree_map(lambda t: t.clone(), _port_like(rstate))
    for dst, src in zip(tree_leaves(mine), jax.tree.leaves(rstate)):
        dst.copy_(lm_params_from_numpy(np.asarray(src), "cpu"))
    specs = state_pspecs(configs.reduced(configs.get_config("granite-moe-1b-a400m")), mine,
                         model_axis_size=1)
    CheckpointManager(str(tmp_path)).save(5, mine, specs=specs, extra={"step": 5})
    like = jax.tree.map(jnp.zeros_like, rstate)
    got, extra = RefCheckpoints(str(tmp_path)).restore(5, like)
    assert extra == {"step": 5}
    _bitwise(jax.tree.leaves(got), tree_leaves(mine))
    # the same manifest the reference writes for the same state and specs
    RefCheckpoints(str(tmp_path / "ref")).save(
        5, rstate, specs=ref_state_pspecs(cfg, rstate, model_axis_size=1), extra={"step": 5})
    ours = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "step_5" / "manifest.json").read_text())
    assert ours == theirs
    for i in range(ours["num_leaves"]):
        assert (tmp_path / "step_5" / f"leaf_{i}.npy").read_bytes() == \
            (tmp_path / "ref" / "step_5" / f"leaf_{i}.npy").read_bytes()


@pytest.mark.parametrize("spec", [(), (None,), ("model", None), (("pod", "data"), None),
                                  (None, "data", "model")])
def test_spec_repr_is_the_reference_partition_spec_repr(spec):
    assert spec_repr(spec) == repr(P(*spec))
    assert spec_repr(None) is None


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    state, stats = launch_train.main([
        "--arch", NAME, "--reduced", "--steps", "3", "--batch", "4", "--seq", "32",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"arch={NAME} steps=3 final_loss=")
    assert "failures=0 stragglers=" in out
    assert stats.steps_done == 3 and np.isfinite(stats.last_loss)
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    assert isinstance(state, TrainState) and int(state.opt.step) == 3
    assert os.path.isdir(tmp_path / "step_2")
    assert dataclasses.is_dataclass(state)
