"""Shared set-up of the port's LM parity tests (``tests/test_torch_lm_*.py``):
a reduced architecture built on both sides from one reference
initialisation, its seeded inputs (token ids, or ``embeds`` and M-RoPE
``pos3`` for the frontend stubs), and the checks every architecture goes
through: parameters bit for bit, full and last-position logits, the MoE aux
loss, a token-by-token decode with its caches, and the port's own init;
and mamba2-370m's prefill-vs-decode gap at depth (``check_mamba2_depth_gap``,
one test file for each depth, so that the two slow cases run in parallel).

Tolerances are the reference suite's: bf16 layer outputs and caches within
3e-2 (``tests/test_kernels.py:98``), logits within 5e-2
(``tests/test_models_lm.py:80``).
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models.lm import LM as RefLM
from repro_torch import configs
from repro_torch.models.lm import LM, lm_params_from_numpy, make_model, padded_vocab

LAYER_TOL = 3e-2
LOGIT_TOL = 5e-2
DECODE_STEPS = 16
# The MoE aux loss of a whole model: the router reads bf16 hidden states,
# and from the first attention layer on the two packages round those at
# different places (their logits differ by up to 7.8e-3), which moves the
# mean gates by about 5e-4 of the aux at these sizes.  At the layer, on the
# same inputs, the aux is held to 1e-5 (test_torch_lm_moe.py).
MODEL_AUX_RTOL = 2e-3


def np32(x):
    """A jax array or a tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def pair(a: np.ndarray, bf16: bool = False):
    """One seeded numpy array as a (jax, torch) pair, bit for bit."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def params_pair(rng, shapes, bf16_keys=()):
    """Seeded parameter dicts ``{key: (shape, scale)}`` on both sides."""
    ref, port = {}, {}
    for k, (shape, scale) in shapes.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        ref[k], port[k] = pair(a, k in bf16_keys)
    return ref, port


def pos3_grid(b: int, s: int) -> np.ndarray:
    """M-RoPE positions (3, B, S) of an image-like grid: temporal, height and
    width components that all differ."""
    i = np.arange(s)
    grid = np.stack([i // 16, (i // 4) % 4, i % 4 + 2 * (i // 64)]).astype(np.int32)
    return np.repeat(grid[:, None], b, axis=1)


def reduced_model(name: str, seq: int, batch: int = 2, ssd_chunk: int = 128):
    """A reduced arch on both sides: ``dict(cfg, ref, rp, port, pp, inputs,
    ref_inputs, tokens, want, aux)``.  ``inputs`` are token ids, or for a
    frontend stub seeded ``embeds`` (and a ``pos3_grid`` where the config
    has M-RoPE sections); ``want`` and ``aux`` are the reference's full
    logits and aux loss for them.  The reference runs its Pallas kernels in
    interpret mode, MLA on ``backend="jnp"`` (its Pallas K4 takes one head
    dim for q, k and v)."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    backend = "jnp" if cfg.mla_kv_rank else "interpret"
    ref = RefLM(cfg, backend=backend, ssd_chunk=ssd_chunk)
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(name)), device="cpu", ssd_chunk=ssd_chunk)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    if cfg.frontend == "none":
        inputs = {"tokens": tokens}
    else:
        inputs = {"embeds": rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)}
        if cfg.mrope_sections is not None:
            inputs["pos3"] = pos3_grid(batch, seq)
    ref_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    want, _, aux = ref.forward(rp, **ref_inputs)
    return dict(cfg=cfg, ref=ref, rp=rp, port=port, pp=pp, tokens=tokens,
                inputs={k: torch.from_numpy(v) for k, v in inputs.items()},
                want=np.asarray(want), aux=float(aux))


def check_params_cross(m) -> None:
    """Every reference leaf crosses bit for bit, dtype included."""
    leaves_ref, leaves_port = jax.tree.leaves(m["rp"]), jax.tree.leaves(m["pp"])
    assert len(leaves_ref) == len(leaves_port)
    for a, b in zip(leaves_ref, leaves_port):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def check_forward(m) -> None:
    """Full and last-position logits within LOGIT_TOL of the reference's,
    the vocab padding masked, and the MoE aux loss."""
    cfg, want = m["cfg"], m["want"]
    v = cfg.vocab_size
    got, cache, aux = m["port"].forward(m["pp"], **m["inputs"])
    assert cache is None
    b, s = want.shape[:2]
    assert got.shape == want.shape == (b, s, padded_vocab(cfg))
    assert bool(torch.isfinite(got[..., :v]).all())
    np.testing.assert_allclose(got.numpy()[..., :v], want[..., :v], atol=LOGIT_TOL)
    if got.shape[-1] > v:
        assert float(got[..., v:].max()) < -1e20
    if cfg.num_experts:
        assert m["aux"] > 0
        assert abs(float(aux) - m["aux"]) <= MODEL_AUX_RTOL * m["aux"], (float(aux), m["aux"])
    else:
        assert float(aux) == 0.0 == m["aux"]
    last, _, _ = m["port"].forward(m["pp"], last_only=True, **m["inputs"])
    assert last.shape == (b, 1, got.shape[-1])
    np.testing.assert_allclose(last.numpy()[..., :v], want[:, -1:, :v], atol=LOGIT_TOL)


def decode_both(m, steps: int = DECODE_STEPS):
    """Token-by-token decode of the seeded tokens on both sides: per step
    ``(port logits, reference logits)`` of the real vocab, and the two
    final caches."""
    ref, rp, port, pp, toks = m["ref"], m["rp"], m["port"], m["pp"], m["tokens"]
    decode = jax.jit(lambda p, t, c, i: ref.forward(p, tokens=t, cache=c, cache_pos=i))
    b = toks.shape[0]
    c_ref, c_port = ref.init_cache(b, steps), port.init_cache(b, steps)
    v = m["cfg"].vocab_size
    out = []
    for i in range(steps):
        lr, c_ref, _ = decode(rp, jnp.asarray(toks[:, i:i + 1]), c_ref, jnp.int32(i))
        lp, c_port, _ = port.forward(pp, tokens=torch.from_numpy(toks[:, i:i + 1]),
                                     cache=c_port, cache_pos=i)
        out.append((lp.numpy()[:, 0, :v], np.asarray(lr)[:, 0, :v]))
    return out, c_ref, c_port


def check_decode(m) -> list:
    """The port's decode within LOGIT_TOL of the reference's step by step,
    its caches within LAYER_TOL; returns the port's per-step logits."""
    steps, c_ref, c_port = decode_both(m)
    errs = [float(np.abs(a - b).max()) for a, b in steps]
    assert max(errs) < LOGIT_TOL, errs
    assert [sorted(c) for c in c_port] == [sorted(c) for c in c_ref]
    for a, b in zip(jax.tree.leaves(c_ref), jax.tree.leaves(c_port)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=LAYER_TOL)
    return [a for a, _ in steps]


def check_init(name: str) -> None:
    """The port's own init: the reference's keys, shapes and dtypes; constant
    leaves (norms, biases) equal, random leaves at the same scale; seeded."""
    cfg = configs.reduced(configs.get_config(name))
    port = make_model(cfg, device="cpu")
    got = port.init(0)
    want = RefLM(ref_configs.reduced(ref_configs.ARCHS[name])).init(jax.random.key(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        a32, b32 = np.asarray(a, np.float32), b.float().numpy()
        if np.all(a32 == a32.flat[0]):  # constant leaves: norms, biases
            assert np.array_equal(a32, b32)
        else:  # random leaves: same scale
            assert abs(b32.std() / a32.std() - 1) < 0.15
    assert torch.equal(port.init(0)["embed"], got["embed"])
    assert not torch.equal(port.init(1)["embed"], got["embed"])


def check_init_cache(name: str) -> None:
    """``init_cache`` has the reference's keys, shapes and dtypes, zeroed."""
    cfg = configs.reduced(configs.get_config(name))
    ref = RefLM(ref_configs.reduced(ref_configs.ARCHS[name]))
    got = LM(cfg, device="cpu").init_cache(3, 20)
    want = ref.init_cache(3, 20)
    assert [sorted(c) for c in got] == [sorted(c) for c in want]
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.any()


def _prefill_decode_gap(prefill, decode, cache, toks, v):
    """max |last-position logits of a prefill - of a token-by-token decode|."""
    pre = np.asarray(prefill(toks), np.float32)[:, -1, :v]
    for i in range(toks.shape[1]):
        step, cache = decode(toks[:, i:i + 1], cache, i)
    return float(np.abs(np.asarray(step, np.float32)[:, 0, :v] - pre).max())


DEPTH_VOCAB = 512  # mamba2-370m's widths, vocab cut
DEPTH_SEQ, DEPTH_CHUNK = 128, 64  # two SSD chunks: the carried state is used
DEPTH_FACTOR = 3


def check_mamba2_depth_gap(layers: int) -> None:
    """In bf16 a prefill and a token-by-token decode of one prompt round at
    different places, and a random-weight stack amplifies it with depth, in
    the reference as in the port.  At mamba2-370m's full mixer width (d 1024,
    32 heads of 64, state 128, vocab cut to 512) and 8 or 16 layers, the
    port's gap must stay within DEPTH_FACTOR times the reference's (or
    LOGIT_TOL): a fault of either path that grows with depth gives a gap the
    size of the logits themselves."""
    name, cut = "mamba2-370m", dict(num_layers=layers, vocab_size=DEPTH_VOCAB)
    ref = RefLM(dataclasses.replace(ref_configs.ARCHS[name], **cut),
                backend="interpret", ssd_chunk=DEPTH_CHUNK)
    port = LM(dataclasses.replace(configs.get_config(name), **cut), device="cpu",
              ssd_chunk=DEPTH_CHUNK)
    rp = ref.init(jax.random.key(0))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(1).integers(0, DEPTH_VOCAB, (2, DEPTH_SEQ)).astype(np.int32)
    jit_decode = jax.jit(lambda p, t, c, i: ref.forward(p, tokens=t, cache=c, cache_pos=i))

    def ref_decode(t, c, i):
        out, c, _ = jit_decode(rp, jnp.asarray(t), c, jnp.int32(i))
        return out, c

    def port_decode(t, c, i):
        out, c, _ = port.forward(pp, tokens=torch.from_numpy(t), cache=c, cache_pos=i)
        return out.numpy(), c

    v = DEPTH_VOCAB
    gaps = {
        "reference": _prefill_decode_gap(
            lambda t: ref.forward(rp, tokens=jnp.asarray(t), last_only=True)[0],
            ref_decode, ref.init_cache(2, DEPTH_SEQ), toks, v),
        "port": _prefill_decode_gap(
            lambda t: port.forward(pp, tokens=torch.from_numpy(t), last_only=True)[0].numpy(),
            port_decode, port.init_cache(2, DEPTH_SEQ), toks, v),
    }
    print(f"mamba2-370m widths, {layers} layers, S={DEPTH_SEQ}: "
          f"max|decode - prefill| of the last logits {gaps}")
    assert 0 < gaps["port"] <= max(DEPTH_FACTOR * gaps["reference"], LOGIT_TOL), gaps
