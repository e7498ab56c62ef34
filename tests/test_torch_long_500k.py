"""The reference's ``long_500k`` cell on the CPU against the JAX package's:
one token decoded at position 524,287 against a cache of 524,288 positions
(``SHAPES["long_500k"]``: B = 1, kind ``decode``), for the two stacks
``cells()`` gives it, mamba2-370m and jamba-v0.1-52b, at reduced width
(``configs.reduced``) and the full sequence length.

The reference's cell decodes against zeros, which cannot show that a step
reads its cache, so both sides get the same seeded numpy cache: the
attention layer's k and v at positions 0..524,286 (position 524,287 is the
step's own), the conv and SSM states.  The port's logits and every cache
leaf are held to the reference's ``LM(backend="jnp")`` (jitted), within the
reference suite's tolerances (``torch_lm_parity``): logits 5e-2 and cache
leaves 3e-2; the cache rows the step does not write stay bit for bit the
seeded ones on both sides.  A step whose attention skips 1/16 of the cached
keys (their values zeroed) must miss the reference's logits by more than
the tolerance.  ``input_specs`` for ``long_500k`` gives ``cache_pos`` =
524,287 and a B = 1 cache whose SSM leaves do not grow with S (on a mesh of
``meta`` ranks: nothing is allocated).

``repro.models.lm`` is imported directly, never ``repro.launch.dryrun``,
which sets ``XLA_FLAGS`` to 512 host devices on import (ROADMAP queue 3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import input_specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.lm import LM, lm_params_from_numpy, padded_vocab  # noqa: E402
from repro_torch.train import tree_leaves  # noqa: E402

LOGIT_TOL, CACHE_TOL = 5e-2, 3e-2  # torch_lm_parity's LOGIT_TOL and LAYER_TOL
ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
SPEC = SHAPES["long_500k"]
FAULT_SHARE = 16  # chip_smoke.py's LONG_FAULT_SHARE


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's parallel workers a thread pool
    a process oversubscribes the cores (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_cache(cache_shapes, seed: int = 0) -> list:
    """numpy leaves for ``init_cache``'s shapes (a list of dicts): k and v
    N(0, 1) in bf16 at positions 0..T-2 and zero at T-1 (the step's own
    row), the conv state N(0, 1) in bf16, the SSM state N(0, 1) float32."""
    rng = np.random.default_rng(seed)
    out = []
    for entry in cache_shapes:
        leaves = {}
        for key, shape in entry.items():
            a = rng.standard_normal(shape, dtype=np.float32)
            if key in ("k", "v"):
                a[..., -1, :] = 0.0
            leaves[key] = a if key == "ssm" else a.astype(ml_dtypes.bfloat16)
        out.append(leaves)
    return out


def to_port(cache_np) -> list:
    """The port's copy of a seeded cache, bit for bit (its steps write the
    copy in place)."""
    return [{k: torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
             if v.dtype.name == "bfloat16" else torch.from_numpy(v.copy())
             for k, v in entry.items()} for entry in cache_np]


def ref_step(name):
    """The reduced reference model, its parameters, the port's model on the
    CPU with the same parameters, and the seeded cache of ``long_500k``."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = RefLM(cfg, backend="jnp")
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(name)), device="cpu")
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    shapes = [{k: tuple(v.shape) for k, v in e.items()}
              for e in jax.eval_shape(lambda: ref.init_cache(SPEC.global_batch, SPEC.seq_len))]
    return cfg, ref, rp, port, pp, seeded_cache(shapes)


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    """Both packages' step at 524,287 from the same seeded cache: the
    reference's logits and cache, the port's, the seeded numpy cache and the
    port's pieces for further steps."""
    name = request.param
    cfg, ref, rp, port, pp, cache_np = ref_step(name)
    pos = SPEC.seq_len - 1
    tok = np.array([[7]], np.int32)
    step = jax.jit(lambda p, t, c: ref.forward(p, tokens=t, cache=c, cache_pos=jnp.int32(pos))[:2])
    want, c_ref = step(rp, jnp.asarray(tok), [{k: jnp.asarray(v) for k, v in e.items()}
                                              for e in cache_np])
    c_port = to_port(cache_np)
    got, out, _ = port.forward(pp, tokens=torch.from_numpy(tok), cache=c_port, cache_pos=pos)
    return dict(name=name, cfg=cfg, want=np.asarray(want, np.float32), c_ref=c_ref,
                got=got, c_port=out, cache_np=cache_np, port=port, pp=pp, tok=tok, pos=pos)


def test_long_500k_decode_logits_match_the_reference(decoded):
    cfg = decoded["cfg"]
    got, want = decoded["got"], decoded["want"]
    v = cfg.vocab_size
    assert got.shape == (1, 1, padded_vocab(cfg))
    assert bool(torch.isfinite(got[..., :v]).all())
    np.testing.assert_allclose(got.numpy()[..., :v], want[..., :v], atol=LOGIT_TOL)


def test_long_500k_every_cache_leaf_matches_the_reference(decoded):
    """Every leaf within 3e-2 of the reference's; the k and v rows the step
    does not write are the seeded bits on both sides, and row 524,287 is
    written (no longer zero)."""
    c_ref, c_port, cache_np = decoded["c_ref"], decoded["c_port"], decoded["cache_np"]
    pos = decoded["pos"]
    for a, b, (key, seeded) in zip(jax.tree.leaves(c_ref), tree_leaves(c_port),
                                   [(k, x) for e in cache_np for k, x in sorted(e.items())]):
        a32, b32 = np.asarray(a, np.float32), b.float().numpy()
        np.testing.assert_allclose(b32, a32, atol=CACHE_TOL)
        if key in ("k", "v"):
            s32 = seeded.astype(np.float32)
            assert np.array_equal(b32[..., :pos, :], s32[..., :pos, :])
            assert np.array_equal(a32[..., :pos, :], s32[..., :pos, :])
            assert np.abs(b32[..., pos, :]).max() > 0
        else:  # the states moved from their seeded values
            assert not np.array_equal(b32, seeded.astype(np.float32))


def attention_limit(max_logit: float) -> float:
    """The per-head limit on ``||o - ref|| / ||ref||`` of the cached step's
    bf16 attention against a float64 plain one on the same q and cache (the
    gate ``chip_smoke.py`` phase 12 holds jamba's step to): each logit is
    rounded to bf16 twice (the product, then the scaled product), ``2^-9 |l|``
    each, and the probabilities and the output once each, ``2^-9`` each."""
    return 2.0 ** -8 * (2.0 + max_logit)


def plain_decode(q, k, v, scale):
    """float64 attention of the one query row at the last position over the
    whole cache, and the largest |logit|."""
    g = q.shape[1] // k.shape[1]
    kf, vf = (x.double().repeat_interleave(g, 1) for x in (k, v))
    logits = (q.double() @ kf.transpose(-1, -2)) * scale
    return torch.softmax(logits, -1) @ vf, float(logits.abs().max())


def head_rms(got, ref) -> torch.Tensor:
    return ((got.double() - ref).square().sum((-1, -2)) / ref.square().sum((-1, -2))).sqrt()


def test_long_500k_step_reads_the_whole_cache(decoded, monkeypatch):
    """jamba: the attention layer's output at the step, captured, against a
    float64 plain attention over the same q and cache, per head within
    ``attention_limit``; a planted fault, the step run with the values of
    1/16 of the cached keys (from the middle of the 524,288) zeroed, must
    read above it.  mamba2-370m has no attention: its step from a zeroed
    SSM state must miss the reference's logits by more than 5e-2."""
    cfg, port, pp = decoded["cfg"], decoded["port"], decoded["pp"]
    cache = to_port(decoded["cache_np"])
    tok = torch.from_numpy(decoded["tok"])
    if not any(m == "attn" for m, _ in cfg.block_pattern):
        for entry in cache:
            entry["ssm"].zero_()
        bad = port.forward(pp, tokens=tok, cache=cache, cache_pos=decoded["pos"])[0]
        v = cfg.vocab_size
        assert float(np.abs(bad.numpy()[..., :v] - decoded["want"][..., :v]).max()) > LOGIT_TOL
        return
    seen = []
    real = L.decode_attention

    def capture(q, k_cache, v_cache, cache_pos, **kw):
        o = real(q, k_cache, v_cache, cache_pos, **kw)
        seen.append((q.clone(), k_cache, v_cache, kw["scale"], o))
        return o

    monkeypatch.setattr(L, "decode_attention", capture)
    port.forward(pp, tokens=tok, cache=cache, cache_pos=decoded["pos"])
    assert len(seen) == cfg.num_groups  # one attention layer a group
    t = SPEC.seq_len
    span = t // FAULT_SHARE
    drop = slice(t // 2 - span // 2, t // 2 - span // 2 + span)
    for q, k, v, scale, o in seen:
        ref, max_logit = plain_decode(q, k, v, scale)
        limit = attention_limit(max_logit)
        assert float(head_rms(o, ref).max()) <= limit
        assert float((o.double() - ref).abs().max()) <= limit * float(ref.abs().max())
        zeroed = v.clone()
        zeroed[:, :, drop] = 0
        bad = real(q, k, zeroed, t - 1, scale=scale)
        assert float(head_rms(bad, ref).max()) > limit


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_give_the_long_500k_cell(name):
    """At full width on ``meta`` ranks: ``cache_pos`` = 524,287, the decode
    token (a copy of its id: a view of the (1, 524,288) ids it was drawn
    from held them all on the card, 2 MiB the dry run does not count), B =
    1, k and v of 524,288 positions, and SSM leaves of the same shapes as a
    16-position cache's (the state does not grow with S)."""
    cfg = configs.get_config(name)
    assert SPEC in configs.cells(cfg)
    mesh = make_mesh_for([torch.device("meta")], shard_axes=("data", "model"), shape=(1, 1))
    ins = input_specs(cfg, SPEC, mesh)
    assert ins["cache_pos"] == 524_287 and tuple(ins["tokens"].shape) == (1, 1)
    # the decode token holds its own id, not a view of the 524,288 drawn
    assert ins["tokens"].untyped_storage().nbytes() == 4
    small = LM(cfg, device="meta").init_cache(1, 16)
    for entry, short in zip(ins["cache"], small):
        for key, leaf in entry.items():
            assert leaf.device.type == "meta" and leaf.shape[1] == 1
            if key in ("k", "v"):
                assert leaf.shape[3] == 524_288
            else:
                assert leaf.shape == short[key].shape


def test_cublas_workspace_bytes_read_the_config(monkeypatch):
    """PyTorch's workspace: 32 MiB on sm_90 unset (measured on an H100:
    the first bf16 GEMM of a process allocates 33,554,432 bytes beyond its
    output), else the ``:SIZE:COUNT`` pairs in KiB."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert dryrun.cublas_workspace_bytes() == 33_554_432
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    assert dryrun.cublas_workspace_bytes() == 33_554_432
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:2:16:8")
    assert dryrun.cublas_workspace_bytes() == (4096 * 2 + 16 * 8) * 1024


@pytest.mark.parametrize("name", ARCHS)
def test_memory_estimate_counts_the_long_500k_step_by_hand(name, monkeypatch):
    """The ``long_500k`` step at B = 1 (jamba at the 8 layers the card runs):
    the parameters and the cache, one token's activations, the attention's
    (query, key) block over the cache (12 bytes x 32 heads x 524,288;
    jamba), the logits (10 bytes x the padded vocab), the cuBLAS workspace
    (32 MiB) and the SSM stack's float32 terms: the output projection
    (d_inner x d_model) and three (H, P, N) states of the recurrence.  On
    one H100 mamba2-370m's step peaked at 796.843 MiB with 2 MiB of the
    (1, 524,288) drawn ids held by the decode token's view (fixed, above);
    the estimate without the workspace, the float32 terms and the logits
    read 752.813 MiB; with them it reads 796.293."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cfg = configs.get_config(name)
    if name == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, num_layers=8)
    est = dryrun.memory_estimate(cfg, SPEC, dryrun.meta_mesh(shape=(1, 1)), 1)
    model = LM(cfg, device="meta")
    params = sum(t.numel() * t.element_size() for t in tree_leaves(model.init(0)))
    cache = sum(t.numel() * t.element_size() for e in model.init_cache(1, SPEC.seq_len)
                for t in e.values())
    assert est["state_bytes_per_rank_estimate"] == params + cache
    if name == "mamba2-370m":
        token = 2 * (2 * 2048 + 2 * 128 + 32) + 4 * 6 * 2048
        attn, vocab, ssm = 0, 50304, 2048 * 1024 + 3 * 32 * 64 * 128
    else:
        token = 2 * (2 * 8192 + 2 * 16 + 128) + 4 * 6 * 8192
        attn, vocab, ssm = 12 * 32 * 524288, 65536, 8192 * 4096 + 3 * 128 * 64 * 16
    want = token + attn + 10 * vocab + 32 * 2 ** 20 + 4 * ssm
    assert est["activation_bytes_per_rank_estimate"] == want
