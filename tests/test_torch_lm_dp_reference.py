"""The port's data-parallel LM train step against the JAX package's.

The reference's ``build_train_step`` is one GSPMD program: whatever the
mesh, a step gives the loss and gradients of the whole global batch.  Its
own step cannot run on this JAX (``tests/test_train.py``'s LM cases), so
its step body is composed from its pieces (``lm_ref_step.ref_step``) and
run on the whole batch.  The port's step over the ``(2, 1)``, ``(4, 1)``
and ``(2, 2, 1)`` (pods) CPU meshes of ``test_torch_lm_dp.py``, from the
reference's parameters on the per-rank batches, is held to it: the loss
within ``REF_LOSS_TOL``, the global norm and the first and second moments
within ``GRAD_RTOL`` of each leaf's largest entry.  For the MoE model the
port routes each token group as the reference did (``_pinned_routing``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro.models.layers as ref_layers  # noqa: E402
from lm_ref_step import max_rel as ref_max_rel  # noqa: E402
from lm_ref_step import ref_model, ref_step  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import lm_params_from_numpy  # noqa: E402
from repro_torch.train import SyntheticTokens, adamw_init, tree_leaves  # noqa: E402
from repro_torch.train._lm_pspecs import data_pspec  # noqa: E402
from repro_torch.train.train_step import TrainState, build_train_step  # noqa: E402
from test_torch_lm_dp import BATCH, GRAD_RTOL, LR, MESHES, SEQ, _mesh, _model  # noqa: E402

REF_LOSS_TOL = 1e-3  # as test_torch_lm_train_stack.py: bf16 layers round at other places


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as in ``test_torch_lm_dp.py`` (restored after
    each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ROW_ULP = 0.25  # the packages' MoE inputs differ by bf16 roundings (|x| < 8)
FLIP_SHARE = 0.01  # tokens whose experts the pin changes, of all routed


@functools.lru_cache(maxsize=None)
def _reference(name, microbatches):
    """The reference's step body on batch 0 from its parameters: ``(its
    parameters as numpy, loss, global norm, moments, routes)``, one compile
    a (model, microbatches) for every mesh.  ``routes`` holds each MoE
    call's token groups (G, Tg, D) as float32 and the top-k experts it
    chose for them (G, Tg, k), recorded from inside the compiled step."""
    ref, rp = ref_model(name, ssd_chunk=8)
    tok, tgt = SyntheticTokens(ref.cfg.vocab_size, SEQ[name], BATCH).host_batch(0)
    routes = []
    moe_ffn = ref_layers.moe_ffn

    def recording(p, x, *, top_k, group_size, **kw):
        xt = x.reshape(-1, group_size, x.shape[-1])
        _, idx = jax.lax.top_k(jax.nn.softmax(xt @ p["w_router"], axis=-1), top_k)
        jax.debug.callback(lambda a, b: routes.append((np.asarray(a, np.float32),
                                                        np.asarray(b))), xt, idx)
        return moe_ffn(p, x, top_k=top_k, group_size=group_size, **kw)

    ref_layers.moe_ffn = recording
    try:
        _, opt, _, loss, norm = ref_step(ref, microbatches, False, LR)(
            rp, ref_optim.adamw_init(rp), None, tok, tgt)
        jax.effects_barrier()
    finally:
        ref_layers.moe_ffn = moe_ffn
    return (jax.tree.map(np.asarray, rp), float(loss), float(norm),
            [np.asarray(x, np.float32) for x in jax.tree.leaves((opt.mu, opt.nu))], routes)


def _pinned_routing(routes, flips):
    """``layers.moe_route`` with each token group's experts (``idx``) the
    reference's for the recorded group nearest to it (the packages' inputs
    to a MoE layer differ by bf16 roundings, other groups by far more), and
    ``gate_vals``, ``keep`` and ``pos`` rebuilt from them as ``moe_route``
    builds them.  A token whose top gates lie within a rounding of each
    other (``test_torch_lm_moe.py``'s near-ties) may otherwise order its
    experts unlike the reference, and that token's expert gradients move
    every MoE leaf's moments, the one-rank step's too.  Adds to ``flips``
    ``[tokens whose idx the pin changed, tokens routed]``."""
    rx = np.concatenate([x for x, _ in routes])
    ri = np.concatenate([i for _, i in routes])
    route = layers.moe_route

    def pinned(p, xt, *, num_experts, top_k, capacity_factor=1.25):
        r = route(p, xt, num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor)
        g, tg, _ = xt.shape
        dist = np.abs(xt.detach().float().numpy()[:, None] - rx[None]).reshape(
            g, rx.shape[0], -1).max(-1)
        assert (dist.min(1) <= ROW_ULP).all()
        idx = torch.from_numpy(ri[dist.argmin(1)]).to(r["idx"].dtype)
        flips[0] += int((idx != r["idx"]).any(-1).sum())
        flips[1] += g * tg
        gate_vals = torch.gather(r["gates"], -1, idx)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
        onehot = F.one_hot(idx, num_experts)
        pos = torch.cumsum(onehot.reshape(g, tg * top_k, num_experts), dim=1) - 1
        pos = pos.reshape(g, tg, top_k, num_experts)
        keep = (pos < r["cap"]) & (onehot > 0)
        return dict(r, idx=idx, gate_vals=gate_vals, keep=keep,
                    pos=torch.where(keep, pos, 0).to(torch.int32))

    return pinned


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SEQ))
def test_data_parallel_step_matches_the_reference_step(name, mesh_key, microbatches,
                                                       monkeypatch):
    """From the reference's parameters, the data-parallel step on the
    per-rank batches against the reference's step body on the whole
    batch: the loss (MoE aux included), the global norm and every moment,
    so a fault that the data-parallel path shares with the one-rank path
    (the aux, a 1/n scale, the update) shows here.  granite-moe routes as
    the reference did (``_pinned_routing``); the pin changes at most
    FLIP_SHARE of the tokens' experts."""
    cfg, model = _model(name)
    params, r_loss, r_norm, r_moments, routes = _reference(name, microbatches)
    flips = [0, 0]
    if routes:
        monkeypatch.setattr(layers, "moe_route", _pinned_routing(routes, flips))
    pp = lm_params_from_numpy(params, "cpu")
    mesh = _mesh(mesh_key)
    data = SyntheticTokens(cfg.vocab_size, SEQ[name], BATCH)
    fn, _ = build_train_step(model, mesh, BATCH, lr=LR, microbatches=microbatches)
    dp, m = fn(TrainState(params=pp, opt=adamw_init(pp), residuals=None),
               data.sharded_batch(0, mesh, data_pspec(mesh, BATCH)))
    assert abs(float(m["loss"]) - r_loss) <= REF_LOSS_TOL
    assert abs(float(m["grad_norm"]) / r_norm - 1) <= GRAD_RTOL
    got = tree_leaves((dp.opt.mu, dp.opt.nu))
    assert len(got) == len(r_moments)
    for a, b in zip(r_moments, got):
        assert ref_max_rel(a, b) <= GRAD_RTOL
    assert bool(routes) == (name == "granite-moe-1b-a400m")
    assert flips[0] <= FLIP_SHARE * flips[1]
    if routes:
        assert flips[1] > 0
