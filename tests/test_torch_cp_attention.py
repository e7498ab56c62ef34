"""The port's zigzag context-parallel attention (``kernels/cp_attention.py``)
on the CPU against the JAX package's.

The reference's ``cp_zigzag_attention`` is a ``shard_map`` over the
ambient mesh's 'model' axis.  It runs here in a subprocess with 4 forced
host devices, under ``jax.jit`` on a ``(1, 4)`` mesh whose axes are
``Auto`` (JAX 0.9 makes ``jax.make_mesh``'s axes ``Explicit``, under which
the call raises; ROADMAP queue 3).  The port runs each of its 4 CPU ranks'
two chunks through K4's plain version.  Also: the chunk order and logical
positions bitwise, plain causal attention and its gradient, ``ops``'s
route under the reference's exact conditions, the 'model' axis check, and
a reduced LM's forward in the native mode against the plain mode.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import repro.kernels.cp_attention as ref_cp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cp_attention as cp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.launch.mesh import get_mesh, make_mesh_for, set_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
P_SHARDS, S, DH = 4, 64, 16
TOL = 2e-5
# (q heads, kv heads, softcap): GQA with and without the softcap, and MHA
CASES = {"gqa": (4, 2, None), "gqa softcap": (4, 2, 5.0), "mha": (2, 2, None)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small ops: under the suite's parallel
    workers a thread pool a process oversubscribes the cores and each small
    op waits on its pool (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REF = """
import functools, json, sys
import numpy as np
import jax
from jax.sharding import AxisType
from repro.kernels.cp_attention import cp_zigzag_attention
cases = json.loads(sys.argv[3])
data = np.load(sys.argv[1])
mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh):
    for name, (hq, hkv, softcap) in cases.items():
        for native in (False, True):
            fn = jax.jit(functools.partial(cp_zigzag_attention, softcap=softcap,
                                           p_shards=4, pre_permuted=native))
            tag = name + (" native" if native else "")
            out[tag] = np.asarray(fn(data[tag + " q"], data[tag + " k"], data[tag + " v"]))
np.savez(sys.argv[2], **out)
"""


def _zig(t: torch.Tensor, p_shards: int = P_SHARDS) -> torch.Tensor:
    """``t`` (B, H, S, D) stored in zigzag chunk order."""
    idx = torch.from_numpy(cp.zigzag_positions(t.shape[2], p_shards))
    return t[:, :, idx]


def _unzig(t: torch.Tensor, p_shards: int = P_SHARDS) -> torch.Tensor:
    idx = torch.from_numpy(np.argsort(cp.zigzag_positions(t.shape[2], p_shards)))
    return t[:, :, idx]


def _inputs(name, seed=0, b=1):
    hq, hkv, _ = CASES[name]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, S, DH), (b, hkv, S, DH), (b, hkv, S, DH)))


def _mesh(n=P_SHARDS):
    return make_mesh_for([CPU] * n, shard_axes=("data", "model"), shape=(1, n))


@pytest.mark.parametrize("two_p", [2, 8, 32])
def test_zigzag_perm_and_positions_are_bitwise_the_reference(two_p):
    assert cp._zigzag_perm(two_p) == ref_cp._zigzag_perm(two_p)
    for s, p in ((64, 4), (4096, 16), (2112, 16), (96, 1)):
        a, b = cp.zigzag_positions(s, p), ref_cp.zigzag_positions(s, p)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cp_attention_matches_the_reference(tmp_path):
    """Both modes, GQA, softcap: the port on 4 CPU ranks against the
    reference's ``shard_map`` on 4 host devices, float32, within 2e-5."""
    feed = {}
    for name in CASES:
        q, k, v = _inputs(name)
        feed.update({name + " q": q, name + " k": k, name + " v": v})
        zq, zk, zv = (_zig(torch.from_numpy(x)).numpy() for x in (q, k, v))
        feed.update({name + " native q": zq, name + " native k": zk, name + " native v": zv})
    np.savez(tmp_path / "in.npz", **feed)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", _REF, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz"), json.dumps(CASES)],
                   env=env, check=True, timeout=120, capture_output=True)
    want = np.load(tmp_path / "out.npz")
    mesh = _mesh()
    for name, (_, _, softcap) in CASES.items():
        for native in (False, True):
            tag = name + (" native" if native else "")
            q, k, v = (torch.from_numpy(feed[f"{tag} {x}"]) for x in "qkv")
            got = cp.cp_zigzag_attention(q, k, v, softcap=softcap, p_shards=P_SHARDS,
                                         pre_permuted=native, mesh=mesh)
            assert np.abs(got.numpy() - want[tag]).max() <= TOL, tag


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cp_attention_is_causal_attention(name, data):
    """Both modes against ``attention_plain(causal=True)``: the native mode
    on permuted inputs, its output permuted back; with a 'data' axis of 2
    the batch splits over it, as the reference's ``shard_map`` splits it."""
    _, _, softcap = CASES[name]
    q, k, v = (torch.from_numpy(x) for x in _inputs(name, seed=1, b=data))
    want = attention_plain(q, k, v, causal=True, softcap=softcap)
    mesh = make_mesh_for([CPU] * (data * P_SHARDS), shard_axes=("data", "model"),
                         shape=(data, P_SHARDS))
    with set_mesh(mesh):
        got = cp.cp_zigzag_attention(q, k, v, softcap=softcap, p_shards=P_SHARDS)
        zz = cp.cp_zigzag_attention(_zig(q), _zig(k), _zig(v), softcap=softcap,
                                    p_shards=P_SHARDS, pre_permuted=True)
    assert float((got - want).abs().max()) <= TOL
    assert float((_unzig(zz) - want).abs().max()) <= TOL
    assert get_mesh() is None


@pytest.mark.parametrize("native", [False, True])
def test_cp_attention_gradient_matches_plain_autograd(native):
    q, k, v = (torch.from_numpy(x) for x in _inputs("gqa softcap", seed=2))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_plain(lq, lk, lv, causal=True, softcap=5.0),
                               (lq, lk, lv), g)
    zq, zk, zv = ((_zig(t) if native else t).clone().requires_grad_(True) for t in (q, k, v))
    out = cp.cp_zigzag_attention(zq, zk, zv, softcap=5.0, p_shards=P_SHARDS,
                                 pre_permuted=native, mesh=_mesh())
    got = torch.autograd.grad(out, (zq, zk, zv), _zig(g) if native else g)
    for a, b in zip(got, want):
        assert float(((_unzig(a) if native else a) - b).abs().max()) <= 1e-5


@pytest.mark.parametrize("impl,causal,window,s,t,routed", [
    ("chunked", True, None, 2112, 2112, False),
    ("chunked2d", True, None, 2112, 2112, False),
    ("cp_zigzag", True, None, 2112, 2112, True),
    ("cp_zigzag_native", True, None, 2112, 2112, True),
    ("cp_zigzag", True, None, 2048, 2048, False),  # S·T not above 2048²
    ("cp_zigzag", True, None, 2100, 2100, False),  # S % 32
    ("cp_zigzag", True, None, 2112, 4224, False),  # S != T
    ("cp_zigzag", False, None, 2112, 2112, False),
    ("cp_zigzag", True, 512, 2112, 2112, False),
])
def test_ops_attention_routes_exactly_under_the_reference_conditions(
        monkeypatch, impl, causal, window, s, t, routed):
    """``ops.attention`` takes the context-parallel route with
    ``p_shards=16`` and the mode's ``pre_permuted`` exactly where the
    reference's ``ops.attention`` does (``ops.py:116-135``); meta tensors,
    so no attention is computed."""
    calls = []
    monkeypatch.setattr(cp, "cp_zigzag_attention",
                        lambda *a, **kw: calls.append(kw) or torch.empty(0))
    monkeypatch.setattr(ops, "ATTN_IMPL", impl)
    q = torch.empty((1, 2, s, 16), device="meta")
    kv = torch.empty((1, 2, t, 16), device="meta")
    ops.attention(q, kv, kv, causal=causal, window=window, softcap=3.0)
    assert bool(calls) == routed
    if routed:
        assert calls[0]["p_shards"] == 16 and calls[0]["softcap"] == 3.0
        assert calls[0]["pre_permuted"] == (impl == "cp_zigzag_native")


def test_model_axis_of_the_wrong_size_raises():
    q = torch.zeros((1, 2, S, DH))
    with pytest.raises(ValueError, match="'model' axis to have 4 ranks"):
        cp.cp_zigzag_attention(q, q, q, p_shards=4, mesh=_mesh(2))
    with pytest.raises(ValueError, match="needs a mesh"):
        cp.cp_zigzag_attention(q, q, q, p_shards=4)
    with pytest.raises(ValueError, match="divisible"):
        cp.cp_zigzag_attention(q[:, :, :60], q[:, :, :60], q[:, :, :60], p_shards=4,
                               mesh=_mesh())


def test_native_mode_forward_is_the_plain_mode_permuted(monkeypatch):
    """A reduced smollm-135m at S = 2112 (the first multiple of 32 past
    S·T > 2048²) on a (1, 16) mesh of CPU ranks: the forward of tokens
    stored in zigzag order under ``cp_zigzag_native`` (RoPE on the logical
    positions) equals the ``cp_zigzag`` forward of the tokens in order,
    with the positions permuted; both take the route once a layer, and
    equal the forward without it within the bf16 stream's rounding."""
    cfg = configs.reduced(configs.get_config("smollm-135m"))
    model = LM(cfg, device="cpu")
    params = model.init(0)
    s = 2112
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, s)))
    pos = torch.from_numpy(cp.zigzag_positions(s, 16))
    calls = []
    real = cp.cp_zigzag_attention
    monkeypatch.setattr(cp, "cp_zigzag_attention",
                        lambda *a, **kw: calls.append(kw["pre_permuted"]) or real(*a, **kw))
    base, _, _ = model.forward(params, tok)
    out = {}
    with set_mesh(make_mesh_for([CPU] * 16, shard_axes=("data", "model"), shape=(1, 16))):
        for impl, t in (("cp_zigzag", tok), ("cp_zigzag_native", tok[:, pos])):
            monkeypatch.setattr(ops, "ATTN_IMPL", impl)
            out[impl], _, _ = model.forward(params, t)
    assert calls == [False] * cfg.num_layers + [True] * cfg.num_layers
    native = out["cp_zigzag_native"][:, torch.argsort(pos)]
    assert float((native - out["cp_zigzag"]).abs().max()) <= 1e-5
    assert float((out["cp_zigzag"] - base).abs().max()) <= 5e-2
