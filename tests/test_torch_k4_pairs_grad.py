"""K4's autograd Function at the head dims the full-width models train it
at, on the CPU, against the JAX package: the forward and ``(dq, dk, dv)``
of ``FlashAttention`` (the plain version and ``attention_vjp`` here)
against ``jax.value_and_grad`` of the reference's jnp attention
(``attention_ref``, what its models differentiate), from the same numpy
inputs, at

* hubert-xlarge's (80, 80), non-causal;
* minicpm3-4b's MLA pair, q/k 96 with v 64, causal, at 96^-0.5;
* gemma2-2b's (256, 256) with its local layers' window and softcap, GQA,
  the queries scaled so that the logits reach the cap.

Each runs whole and in query tiles of 7 rows (``VJP_TILE_ELEMS`` cut), the
path the backward takes beyond S·T = 2048².  Both sides compute in float32
in another order, so every tensor is held to 1e-5 of its largest entry;
a planted fault of each setting (a causal mask; the padded 128's scale;
the softcap left out) must miss by more than 100 times that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import attention_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

RTOL = 1e-5  # of each tensor's largest entry: float32 on both sides
# name -> (B, Hq, Hkv, S, Dqk, Dv, causal, window, softcap, q scale)
SETTINGS = {
    "hubert-xlarge (80, 80)": (1, 4, 4, 48, 80, 80, False, None, None, 1.0),
    "minicpm3-4b MLA (96, 64)": (1, 4, 4, 40, 96, 64, True, None, None, 1.0),
    "gemma2-2b local (256, 256)": (1, 4, 2, 64, 256, 256, True, 16, 50.0, 25.0),
}


def _inputs(setting, seed):
    b, hq, hkv, s, dqk, dv, _, _, _, q_scale = setting
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, dqk)).astype(np.float32) * np.float32(q_scale)
    k = rng.standard_normal((b, hkv, s, dqk)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dv)).astype(np.float32)
    g = rng.standard_normal((b, hq, s, dv)).astype(np.float32)
    return q, k, v, g


def _port(q, k, v, g, causal, window, softcap, scale):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.FlashAttention.apply(qt, kt, vt, causal, window, softcap, scale)
    return (out.detach().numpy(),) + tuple(
        t.numpy() for t in torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g)))


def _reference(q, k, v, g, causal, window, softcap, scale):
    def f(q_, k_, v_):
        out = attention_ref(q_, k_, v_, causal=causal, window=window, softcap=softcap,
                            scale=scale)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(t) for t in grads)


def _worst(got, want) -> float:
    """The largest error over (out, dq, dk, dv), each over its largest entry."""
    return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_k4_function_gradient_matches_the_reference_at_the_true_head_dims(
        monkeypatch, name, tiled):
    setting = SETTINGS[name]
    causal, window, softcap = setting[6:9]
    scale = setting[4] ** -0.5  # the true Dqk's, as the models pass it
    q, k, v, g = _inputs(setting, seed=len(name))
    if tiled:
        monkeypatch.setattr(fa, "VJP_TILE_ELEMS", setting[3] * 7)
    want = _reference(q, k, v, g, causal, window, softcap, scale)
    got = _port(q, k, v, g, causal, window, softcap, scale)
    assert [a.shape for a in got] == [b.shape for b in want]
    assert got[3].shape[-1] == setting[5]  # dv at v's own head dim
    err = _worst(got, want)
    assert err <= RTOL, (name, err)
    # the planted fault of each setting reads above the tolerance
    if not causal:
        fault = _port(q, k, v, g, True, window, softcap, scale)
    elif softcap is None:
        padded = fa.padded_head_dim(*setting[4:6]) ** -0.5
        fault = _port(q, k, v, g, causal, window, softcap, padded)
    else:
        fault = _port(q, k, v, g, causal, window, None, scale)
    assert _worst(fault, want) > 100 * RTOL, name
