"""Port parity of the LM frontends and the hybrid: M-RoPE
(``mrope_cos_sin``, the ``pos3`` input), the ``embeds`` input of the audio
and vision stubs, the encoder's non-causal attention and ``gelu_mlp`` FFN,
on reduced qwen2-vl-7b, hubert-xlarge and jamba-v0.1-52b (SSM, attention,
MLP and MoE layers in one group) against the JAX package's LM on the CPU."""
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
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from torch_lm_parity import (LAYER_TOL, check_decode,  # noqa: E402
                             check_forward, check_init, check_init_cache,
                             check_params_cross, np32, pair, params_pair,
                             pos3_grid, reduced_model)

ROPE_TOL = 1e-6


# ---------------------------------------------------------------- M-RoPE ---
@pytest.mark.parametrize("sections,dim,theta", [((4, 2, 2), 16, 1e4),
                                                ((16, 24, 24), 128, 1e6)])
def test_mrope_matches_reference(sections, dim, theta):
    """Random position components that all differ: each channel rotated by
    its own section's component, as the reference's one-hot einsum does."""
    rng = np.random.default_rng(30)
    pos3 = rng.integers(0, 4096, (3, 2, 24)).astype(np.int32)
    cj, sj = ref_layers.mrope_cos_sin(jnp.asarray(pos3), sections, dim, theta)
    ct, st = layers.mrope_cos_sin(torch.from_numpy(pos3), sections, dim, theta)
    assert ct.shape == (2, 24, dim // 2) and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ROPE_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ROPE_TOL)
    # each section reads its own component
    lo = 0
    for c, n in enumerate(sections):
        rc, _ = layers.rope_cos_sin(torch.from_numpy(pos3[c]), dim, theta)
        assert torch.equal(ct[..., lo:lo + n], rc[..., lo:lo + n])
        lo += n


def test_mrope_with_equal_components_is_rope():
    """The reference's test_mrope_sections: equal components give plain
    RoPE, differing ones do not."""
    pos = np.arange(8, dtype=np.int32)[None]
    cos3, sin3 = layers.mrope_cos_sin(torch.from_numpy(np.stack([pos] * 3)), (4, 2, 2), 16)
    cos1, sin1 = layers.rope_cos_sin(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(cos3.numpy(), cos1.numpy(), atol=ROPE_TOL)
    np.testing.assert_allclose(sin3.numpy(), sin1.numpy(), atol=ROPE_TOL)
    cos3b, _ = layers.mrope_cos_sin(torch.from_numpy(np.stack([pos, pos * 2, pos * 3])),
                                    (4, 2, 2), 16)
    assert not np.allclose(cos3b.numpy(), cos1.numpy())
    with pytest.raises(ValueError, match="sum to dim/2"):
        layers.mrope_cos_sin(torch.from_numpy(np.stack([pos] * 3)), (4, 2, 1), 16)


# --------------------------------------------------------------- encoder ---
def test_gelu_mlp_matches_reference():
    """The encoder FFN, ``jax.nn.gelu(h @ w_up) @ w_down`` in the reference
    (``lm.py:191``): gelu's tanh approximation, bf16 throughout."""
    rng = np.random.default_rng(31)
    shapes = {"w_up": ((64, 128), 0.1), "w_down": ((128, 64), 0.1)}
    p_ref, p_port = params_pair(rng, shapes, bf16_keys=("w_up", "w_down"))
    xj, xt = pair(rng.standard_normal((2, 8, 64)).astype(np.float32), bf16=True)
    want = jax.nn.gelu(xj @ p_ref["w_up"]) @ p_ref["w_down"]
    got = layers.gelu_mlp(p_port, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=LAYER_TOL)
    # float32: the tanh form to 1e-6, not the erf one
    h = rng.standard_normal((4, 64)).astype(np.float32) * 3
    eye = np.eye(64, dtype=np.float32)
    f32 = {"w_up": torch.from_numpy(eye), "w_down": torch.from_numpy(eye)}
    np.testing.assert_allclose(layers.gelu_mlp(f32, torch.from_numpy(h)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(h))), atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(h)))).max() > 1e-4


# ---------------------------------------------------------------- models ---
FRONTEND_MODELS = {"qwen2-vl-7b": 64, "hubert-xlarge": 64, "jamba-v0.1-52b": 128}


@pytest.fixture(scope="module", params=sorted(FRONTEND_MODELS))
def frontend_model(request):
    return reduced_model(request.param, FRONTEND_MODELS[request.param])


def test_frontend_model_params_cross_bit_for_bit(frontend_model):
    check_params_cross(frontend_model)


def test_frontend_model_forward_matches_reference(frontend_model):
    """qwen2-vl from ``embeds`` with a ``pos3`` grid whose components
    differ, hubert from ``embeds`` (non-causal), jamba from tokens (its aux
    summed over its 4 MoE layers of 16)."""
    cfg = frontend_model["cfg"]
    assert ("pos3" in frontend_model["inputs"]) == (cfg.mrope_sections is not None)
    assert ("embeds" in frontend_model["inputs"]) == (cfg.frontend != "none")
    check_forward(frontend_model)


def test_frontend_model_decode_matches_reference_decode(frontend_model):
    """Token-by-token decode (qwen2-vl from tokens: M-RoPE with the position
    on all three components); the encoder has no decode path."""
    if frontend_model["cfg"].family == "encoder":
        with pytest.raises(ValueError, match="encoder"):
            serve_cli.serve("hubert-xlarge", device="cpu", use_reduced=True)
        return
    check_decode(frontend_model)


@pytest.mark.parametrize("name", sorted(FRONTEND_MODELS))
def test_frontend_model_init_keys_shapes_dtypes_and_scale(name):
    check_init(name)


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "jamba-v0.1-52b"])
def test_frontend_init_cache_matches_reference_layout(name):
    check_init_cache(name)


def test_mrope_embeds_of_tokens_with_broadcast_pos3_is_the_token_forward():
    """qwen2-vl: ``embeds = embed[tokens]`` with ``pos3`` the positions on
    all three components is the token forward, bit for bit (no gemma
    scaling of embeds); another pos3 grid moves the logits."""
    from repro_torch import configs
    from repro_torch.models.lm import LM

    port = LM(configs.reduced(configs.get_config("qwen2-vl-7b")), device="cpu")
    pp = port.init(0)
    b, s = 2, 64
    toks = torch.from_numpy(np.random.default_rng(32).integers(0, 512, (b, s)))
    pos = torch.arange(s)[None].expand(b, s)
    by_tokens, _, _ = port.forward(pp, tokens=toks)
    by_embeds, _, _ = port.forward(pp, embeds=pp["embed"][toks],
                                   pos3=pos[None].expand(3, b, s))
    assert torch.equal(by_tokens, by_embeds)
    moved, _, _ = port.forward(pp, embeds=pp["embed"][toks],
                               pos3=torch.from_numpy(pos3_grid(b, s)))
    assert torch.equal(moved[:, :1], by_tokens[:, :1])  # position 0 is (0, 0, 0) in both
    assert not torch.equal(moved[:, 1:], by_tokens[:, 1:])
