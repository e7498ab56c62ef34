"""Port MoE parity: ``repro_torch.models.layers.moe_ffn`` (GShard grouped,
capacity-based top-k routing, bf16 dispatch and combine einsums, the Switch
aux loss) and its float32 plain version on the CPU against the JAX
package's ``moe_ffn``; reduced olmoe-1b-7b and granite-moe-1b-a400m against
the reference LM (forward, decode, caches, init); and their serving engine
and command line."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from test_torch_serve import (_assert_same_tokens, _engines,  # noqa: E402
                              _record_step_logits, _requests)
from repro_torch.serve.engine import Request  # noqa: E402
from torch_lm_parity import (LAYER_TOL, check_decode, check_forward,  # noqa: E402
                             check_init, check_params_cross, np32, pair,
                             params_pair, reduced_model)

NEAR_TIE = 1e-6  # gates this close may order differently in the two packages
AUX_RTOL = 1e-5
# (d, experts, top-k, expert d_ff, group, tokens): the reduced configs'
# routing, olmoe-1b-7b's (64 experts, top 8, capacity 80 in a group of 512)
# and jamba-v0.1-52b's (16, top 2) at a narrow width
MOE_CASES = {
    "reduced": (64, 4, 2, 64, 64, 128),
    "olmoe": (64, 64, 8, 32, 512, 1024),
    "jamba": (64, 16, 2, 32, 512, 1024),
}


def _moe_setup(rng, d, e, f, tokens, skew=0.0):
    """Seeded MoE weights (bf16 experts, float32 router) and bf16 tokens
    (1, tokens, d); ``skew`` adds a shared offset to every token along
    expert 0's router column, so expert 0 is most tokens' top choice."""
    p_ref, p_port = params_pair(rng, {
        "w_router": ((d, e), 0.5), "w_gate": ((e, d, f), 0.1), "w_up": ((e, d, f), 0.1),
        "w_down": ((e, f, d), 0.1)}, bf16_keys=("w_gate", "w_up", "w_down"))
    x = rng.standard_normal((1, tokens, d)).astype(np.float32)
    if skew:
        col = np.asarray(p_ref["w_router"])[:, 0]
        x += skew * col / np.linalg.norm(col) ** 2
    xj, xt = pair(x, bf16=True)
    return p_ref, p_port, xj, xt


def _ref_route(p, x, e, k, group, cf=1.25):
    """The reference's routing, step for step as ``repro.models.layers.
    moe_ffn`` computes it (``layers.py:226-241``), which returns only the
    output and aux: gates, idx, keep, pos."""
    b, s, d = x.shape
    g = b * s // group
    xt = x.reshape(g, group, d)
    gates = jax.nn.softmax(xt @ p["w_router"], axis=-1)
    _, idx = jax.lax.top_k(gates, k)
    cap = max(int(np.ceil(group * k * cf / e)), k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(g, group * k, e), axis=1) - 1
    pos = pos.reshape(g, group, k, e)
    keep = (pos < cap) & (onehot > 0)
    pos = jnp.where(keep, pos, 0).astype(jnp.int32)
    return np.asarray(gates), np.asarray(idx), np.asarray(keep), np.asarray(pos)


def _near_ties(gates, k):
    """Per token: whether two of its top k + 1 gates lie within NEAR_TIE,
    where the order of the top k (or the k-th against the next) may flip
    between the packages' float32 router products."""
    top = -np.sort(-gates, axis=-1)[..., :k + 1]
    return (np.diff(-top, axis=-1) <= NEAR_TIE).any(-1)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_routing_is_the_references(case):
    """idx bitwise the reference's for every token outside near-ties of the
    gates (counted and printed); keep and pos bitwise for every token of a
    group before its first token whose idx differs from the reference's
    (a near-tie that flipped).  Queue positions count over the flattened
    (token, slot) order, so they are a function of the idx of that token and
    the ones before it: a flip moves nothing before it."""
    d, e, k, f, group, tokens = MOE_CASES[case]
    rng = np.random.default_rng(10)
    p_ref, p_port, xj, xt = _moe_setup(rng, d, e, f, tokens)
    gates, idx, keep, pos = _ref_route(p_ref, xj, e, k, group)
    r = layers.moe_route(p_port, xt.reshape(-1, group, d), num_experts=e, top_k=k)
    assert r["cap"] == max(int(np.ceil(group * k * 1.25 / e)), k)
    np.testing.assert_allclose(r["gates"].numpy(), gates, rtol=1e-5, atol=1e-7)
    tie = _near_ties(gates, k)  # (G, Tg)
    flip = (r["idx"].numpy() != idx).any(-1)
    assert not (flip & ~tie).any()  # idx bitwise outside near-ties
    before = np.cumsum(flip, axis=-1) == 0  # tokens before their group's first flip
    print(f"{case}: {int(tie.sum())} near-tie tokens of {tie.size}, {int(flip.sum())} "
          f"flipped; keep and pos compared on {before.sum(-1).tolist()} tokens of "
          f"{group} a group")
    assert tie.mean() < 0.01
    assert before[:, 0].all()  # every group's queues are compared
    assert np.array_equal(r["keep"].numpy()[before], keep[before])
    assert np.array_equal(r["pos"].numpy()[before], pos[before])
    assert r["pos"].dtype == torch.int32


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    d, e, k, f, group, tokens = MOE_CASES[case]
    rng = np.random.default_rng(11)
    p_ref, p_port, xj, xt = _moe_setup(rng, d, e, f, tokens)
    want, aux_ref = ref_layers.moe_ffn(p_ref, xj, num_experts=e, top_k=k, group_size=group)
    got, terms = layers.moe_ffn(p_port, xt, num_experts=e, top_k=k, group_size=group)
    aux = layers.moe_aux(*terms)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), atol=LAYER_TOL)
    assert abs(float(aux) - float(aux_ref)) <= AUX_RTOL * float(aux_ref)


def test_moe_capacity_drops_match_reference():
    """Top 2 of 4 experts with a router skewed to expert 0: its queue
    overflows the capacity (ceil(128 * 2 * 1.25 / 4) = 80 a group), the
    dropped (token, slot)s add nothing, as in the reference."""
    d, e, k, f, group, tokens = 32, 4, 2, 16, 128, 256
    rng = np.random.default_rng(3)
    p_ref, p_port, xj, xt = _moe_setup(rng, d, e, f, tokens, skew=4.0)
    r = layers.moe_route(p_port, xt.reshape(-1, group, d), num_experts=e, top_k=k)
    kept = int(r["keep"].sum())
    assert kept < tokens * k  # drops occur
    assert (r["idx"][..., 0] == 0).float().mean() > 0.5
    _, idx, keep, _ = _ref_route(p_ref, xj, e, k, group)
    assert int(keep.sum()) == kept
    want, aux_ref = ref_layers.moe_ffn(p_ref, xj, num_experts=e, top_k=k, group_size=group)
    got, terms = layers.moe_ffn(p_port, xt, num_experts=e, top_k=k, group_size=group)
    aux = layers.moe_aux(*terms)
    np.testing.assert_allclose(np32(got), np32(want), atol=LAYER_TOL)
    assert abs(float(aux) - float(aux_ref)) <= AUX_RTOL * float(aux_ref)
    plain = layers.moe_plain(p_port, xt, r)
    np.testing.assert_allclose(np32(got), plain.numpy(), atol=LAYER_TOL)
    # a token whose slots were all dropped gets exactly zero
    dropped = ~r["keep"].any(-1).any(-1).reshape(-1)
    if bool(dropped.any()):
        assert not got.reshape(-1, d)[dropped].any()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_einsum_dispatch_equals_the_plain_version(case):
    """The bf16 dispatch, expert and combine einsums against the per-token
    float32 loop over the router's own slots."""
    d, e, k, f, group, tokens = MOE_CASES[case]
    rng = np.random.default_rng(12)
    _, p_port, _, xt = _moe_setup(rng, d, e, f, tokens)
    got, _ = layers.moe_ffn(p_port, xt, num_experts=e, top_k=k, group_size=group)
    r = layers.moe_route(p_port, xt.reshape(-1, group, d), num_experts=e, top_k=k)
    plain = layers.moe_plain(p_port, xt, r)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(np32(got), plain.numpy(), atol=LAYER_TOL)
    # the plain version sees a dropped expert: zeroing one expert's output
    # moves it past the tolerance
    p_cut = dict(p_port, w_down=p_port["w_down"].clone())
    p_cut["w_down"][int(r["idx"][0, 0, 0])] = 0
    cut = layers.moe_plain(p_cut, xt, r)
    assert float((cut - plain).abs().max()) > LAYER_TOL


def test_moe_ffn_refuses_a_ragged_group():
    _, p_port, _, xt = _moe_setup(np.random.default_rng(0), 16, 4, 8, 48)
    with pytest.raises(ValueError, match="groups of 32"):
        layers.moe_ffn(p_port, xt, num_experts=4, top_k=2, group_size=32)


# ---------------------------------------------------------------- models ---
MOE_MODELS = {"olmoe-1b-7b": 64, "granite-moe-1b-a400m": 64}  # arch -> prefill length


@pytest.fixture(scope="module", params=sorted(MOE_MODELS))
def moe_model(request):
    return reduced_model(request.param, MOE_MODELS[request.param])


def test_moe_model_params_cross_bit_for_bit(moe_model):
    check_params_cross(moe_model)
    assert moe_model["pp"]["blocks"][0]["ffn"]["w_router"].dtype == torch.float32


def test_moe_model_forward_matches_reference(moe_model):
    check_forward(moe_model)


def test_moe_model_decode_matches_reference_decode(moe_model):
    check_decode(moe_model)


@pytest.mark.parametrize("name", sorted(MOE_MODELS))
def test_moe_model_init_keys_shapes_dtypes_and_scale(name):
    check_init(name)


def test_moe_serve_matches_reference_engine():
    """Reduced olmoe-1b-7b through both engines: every slot decodes in one
    MoE group (capacity coupled across the batch), as in the reference."""
    cfg, ref, port = _engines("olmoe-1b-7b", slots=2, max_len=32)
    steps = _record_step_logits(ref)
    done_ref = ref.run(_requests(RefRequest, cfg, 5, 4, 4, seed=0), max_steps=64)
    done_port = port.run(_requests(Request, cfg, 5, 4, 4, seed=0), max_steps=64)
    assert set(done_port) == {0, 1, 2, 3, 4}
    assert all(len(v) == 4 for v in done_port.values())
    _assert_same_tokens(done_ref, done_port, steps)
    for a, b in zip(jax.tree.leaves(ref.cache), jax.tree.leaves(port.cache)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=LAYER_TOL)


def test_serve_cli_serves_a_moe_arch_on_the_cpu(capsys):
    serve_cli.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "on cpu" in out
