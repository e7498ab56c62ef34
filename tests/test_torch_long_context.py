"""The port's long-context paths on the CPU against the JAX package's: the
reference's ``prefill_32k``, ``decode_32k`` and zigzag-CP cells at reduced
sizes, and the cell builder and dry-run variants that plan them.

  * zigzag CP through ``LM.loss`` and its gradient: reduced smollm-135m, B =
    1, S = 4096 (the shortest S the reference routes through CP,
    ``ops.py:124``), on a ``(1, 16)`` mesh of CPU ranks, in both modes,
    against ``jax.value_and_grad`` of the reference's ``LM.loss``
    (``backend="jnp"``, remat full).  The reference's ``shard_map`` runs
    only jitted on ``Auto`` mesh axes (ROADMAP queue 3), so it runs in a
    subprocess with 16 forced host devices, from parameters this process
    draws and hands over; also against the port's own one-call loss;
  * the native mode's ``last_only`` row: the last *stored* row, logical
    position (P + 1) c - 1, in both packages;
  * a chunked cache fill then one decode step (reduced smollm, gemma2 and
    minicpm3, S = 256, chunks of 64) against the reference doing the same
    and against the port's prefill;
  * ``launch/cells.py``'s ``build_cell_fn`` for every cell of ``cells()`` on
    a mesh of ``meta`` ranks, and a small real run of each kind;
  * ``roofline_cell``'s variants and the settings it puts back; the memory
    estimate's K5 scratch and fill block by hand.

Tolerances: against the reference, the loss within 1e-3 and every gradient
leaf within 5e-2 of its largest entry (``test_torch_lm_train.py``'s: bf16
layers round at other places in the two packages), logits within 5e-2
(``torch_lm_parity.LOGIT_TOL``); the CP loss against the one-call loss
within 1e-4, and its gradient leaves within 2e-2 of each leaf's largest
entry, the gate ``chip_smoke.py`` holds a step computed over other
partitions of the same work to (``MB_LEAF_RTOL``): the leaves are bf16, and
the chunk calls' float32 attention sums in another order than one call's,
which flips roundings of the bf16 activations and gradients (the worst leaf
reads 5.9e-3 here, one or two bf16 steps at its largest entry).
"""
import dataclasses
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.kernels.cp_attention as ref_cp  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cp_attention as cp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import build_cell_fn, frame_embeddings, input_specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for, set_mesh  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.models.lm import LM, lm_params_from_numpy, padded_vocab  # noqa: E402
from repro_torch.train import SyntheticTokens, tree_leaves, value_and_grad  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
CP_SEQ, CP_SHARDS = 4096, 16
REF_LOSS_TOL, REF_LEAF_RTOL, LOGIT_TOL = 1e-3, 5e-2, 5e-2
CP_LOSS_TOL, CP_LEAF_RTOL = 1e-4, 2e-2
MODES = ("cp_zigzag", "cp_zigzag_native")
FILL_SEQ, FILL_CHUNK = 256, 64
FILL_ARCHS = ("smollm-135m", "gemma2-2b", "minicpm3-4b")


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
import sys
import numpy as np
import jax, jax.numpy as jnp, ml_dtypes
from jax.sharding import AxisType
import repro.configs as C
from repro.kernels import ops
from repro.models.lm import LM
data = np.load(sys.argv[1])
model = LM(C.reduced(C.ARCHS["smollm-135m"]), backend="jnp", remat="full")
shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
treedef = jax.tree.structure(shapes)
leaves = [data[f"p{i}"].view(ml_dtypes.bfloat16) if x.dtype == jnp.bfloat16 else data[f"p{i}"]
          for i, x in enumerate(jax.tree.leaves(shapes))]
params = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
mesh = jax.make_mesh((1, 16), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh):
    for mode in ("cp_zigzag", "cp_zigzag_native"):
        ops.ATTN_IMPL = mode
        tok, tgt = jnp.asarray(data[mode + " tok"]), jnp.asarray(data[mode + " tgt"])

        def run(p, t, g):
            loss, grads = jax.value_and_grad(lambda q: model.loss(q, t, g))(p)
            last = model.forward(p, tokens=t, last_only=True)[0]
            full = model.forward(p, tokens=t)[0]
            return loss, grads, last, full[:, -1:]

        loss, grads, last, stored = jax.jit(run)(params, tok, tgt)
        out[mode + " loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{mode} g{i}"] = np.asarray(g, np.float32)
        out[mode + " last"] = np.asarray(last)
        out[mode + " stored last"] = np.asarray(stored)
np.savez(sys.argv[2], **out)
"""


def _cp_mesh():
    return make_mesh_for([CPU] * CP_SHARDS, shard_axes=("data", "model"), shape=(1, CP_SHARDS))


@pytest.fixture(scope="module")
def cp_case(tmp_path_factory):
    """The reference's and the port's CP loss, gradients and native-mode
    rows at reduced smollm-135m, B = 1, S = 4096, from one set of the
    reference's parameters; and the port's one-call loss and gradients."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ref_configs.reduced(ref_configs.ARCHS["smollm-135m"])
        rp = RefLM(cfg, backend="jnp").init(jax.random.key(0))
        leaves = [np.asarray(x) for x in jax.tree.leaves(rp)]
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, CP_SEQ + 1)).astype(
            np.int32)
        tok, tgt = toks[:, :-1], toks[:, 1:]
        pos = cp.zigzag_positions(CP_SEQ, CP_SHARDS)
        inputs = {"cp_zigzag": (tok, tgt), "cp_zigzag_native": (tok[:, pos], tgt[:, pos])}
        feed = {f"p{i}": (x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x)
                for i, x in enumerate(leaves)}
        for mode, (t, g) in inputs.items():
            feed[mode + " tok"], feed[mode + " tgt"] = t, g
        tmp = tmp_path_factory.mktemp("cp_reference")
        np.savez(tmp / "in.npz", **feed)
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=16")
        subprocess.run([sys.executable, "-c", _REF, str(tmp / "in.npz"), str(tmp / "out.npz")],
                       env=env, check=True, timeout=900, capture_output=True)
        ref = dict(np.load(tmp / "out.npz"))

        model = LM(configs.reduced(configs.get_config("smollm-135m")), device="cpu",
                   remat="full")
        pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
        port = {}

        def loss_and_grads(t, g):
            tt, tg = torch.from_numpy(t), torch.from_numpy(g)
            loss, (grads,) = value_and_grad(lambda p: model.loss(p, tt, tg), pp)
            return float(loss), [x.float() for x in tree_leaves(grads)]

        port["one call"] = loss_and_grads(tok, tgt)
        impl = ops.ATTN_IMPL
        with set_mesh(_cp_mesh()):
            try:
                for mode, (t, g) in inputs.items():
                    ops.ATTN_IMPL = mode
                    port[mode] = loss_and_grads(t, g)
                    tt = torch.from_numpy(t)
                    port[mode + " last"] = model.forward(pp, tt, last_only=True)[0]
                    port[mode + " stored last"] = model.forward(pp, tt)[0][:, -1:]
            finally:
                ops.ATTN_IMPL = impl
        return {"ref": ref, "port": port, "vocab": cfg.vocab_size, "pos": pos}
    finally:
        torch.set_num_threads(threads)


def _worst_leaf(got, want) -> float:
    """The worst leaf's max |got - want| over that leaf's largest entry."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


@pytest.mark.parametrize("mode", MODES)
def test_cp_loss_and_every_gradient_leaf_match_the_reference(cp_case, mode):
    ref, port = cp_case["ref"], cp_case["port"]
    loss, grads = port[mode]
    want = [torch.from_numpy(ref[f"{mode} g{i}"]) for i in range(len(grads))]
    assert all(a.shape == b.shape for a, b in zip(grads, want)) and len(want) == len(grads)
    assert abs(loss - float(ref[mode + " loss"])) <= REF_LOSS_TOL
    assert _worst_leaf(grads, want) <= REF_LEAF_RTOL


@pytest.mark.parametrize("mode", MODES)
def test_cp_loss_and_every_gradient_leaf_match_the_one_call_loss(cp_case, mode):
    """The native mode's tokens and targets are the plain mode's permuted, so
    its mean loss is the same sum in another order."""
    port = cp_case["port"]
    loss, grads = port[mode]
    one_loss, one_grads = port["one call"]
    assert abs(loss - one_loss) <= CP_LOSS_TOL
    assert _worst_leaf(grads, one_grads) <= CP_LEAF_RTOL
    assert abs(port["cp_zigzag_native"][0] - port["cp_zigzag"][0]) <= CP_LOSS_TOL


def test_native_mode_last_only_row_is_the_same_row_in_both_packages(cp_case):
    """Under ``cp_zigzag_native`` ``last_only`` returns the last stored row,
    whose logical position is (P + 1) c - 1 (``_zigzag_perm`` ends with
    chunk P), not S - 1, in both packages; the plain mode's is S - 1."""
    ref, port, v, pos = cp_case["ref"], cp_case["port"], cp_case["vocab"], cp_case["pos"]
    c = CP_SEQ // (2 * CP_SHARDS)
    for zig in (cp, ref_cp):
        assert zig._zigzag_perm(2 * CP_SHARDS)[-1] == CP_SHARDS
        assert int(zig.zigzag_positions(CP_SEQ, CP_SHARDS)[-1]) == (CP_SHARDS + 1) * c - 1
    assert int(pos[-1]) == (CP_SHARDS + 1) * c - 1 != CP_SEQ - 1
    native = "cp_zigzag_native"
    np.testing.assert_allclose(ref[native + " last"], ref[native + " stored last"], atol=1e-5)
    last = port[native + " last"]
    assert float((last - port[native + " stored last"]).abs().max()) <= 1e-5
    np.testing.assert_allclose(last.numpy()[..., :v], ref[native + " last"][..., :v],
                               atol=LOGIT_TOL)
    # the plain mode's last row (logical S - 1) is another row
    assert float((last - port["cp_zigzag last"]).abs()[..., :v].max()) > LOGIT_TOL


def _chunked_fill(forward, cache, tokens, chunk):
    """Fill ``cache`` with ``tokens[:, :-1]`` in chunks of at most ``chunk``
    through ``forward(tokens, cache, cache_pos)``, then decode the last
    token; its logits and the cache."""
    s = tokens.shape[1]
    for i in range(0, s - 1, chunk):
        _, cache = forward(tokens[:, i:min(i + chunk, s - 1)], cache, i)
    return forward(tokens[:, s - 1:], cache, s - 1)


@pytest.mark.parametrize("name", FILL_ARCHS)
def test_chunked_fill_then_decode_matches_the_reference_and_the_prefill(name):
    """Reduced models, B = 2, S = 256: the first 255 tokens go into the
    cache in chunks of 64 (the last of 63) through the cached forward, then
    token 255 is decoded, on both sides; the port's decode logits and cache
    against the reference's, and against the port's prefill of all 256
    tokens (K4's plain version on the CPU)."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = RefLM(cfg, backend="jnp")
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(name)), device="cpu")
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, FILL_SEQ)).astype(
        np.int32)
    v = cfg.vocab_size
    step = jax.jit(lambda p, t, c, i: ref.forward(p, tokens=t, cache=c, cache_pos=i)[:2])
    want, c_ref = _chunked_fill(lambda t, c, i: step(rp, jnp.asarray(t), c, jnp.int32(i)),
                                ref.init_cache(2, FILL_SEQ), tokens, FILL_CHUNK)
    got, c_port = _chunked_fill(
        lambda t, c, i: port.forward(pp, tokens=torch.from_numpy(t), cache=c, cache_pos=i)[:2],
        port.init_cache(2, FILL_SEQ), tokens, FILL_CHUNK)
    assert got.shape == (2, 1, padded_vocab(cfg))
    np.testing.assert_allclose(got.numpy()[..., :v], np.asarray(want)[..., :v], atol=LOGIT_TOL)
    for a, b in zip(jax.tree.leaves(c_ref), tree_leaves(c_port)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), atol=3e-2)
    prefill = port.forward(pp, torch.from_numpy(tokens), last_only=True)[0]
    assert float((got - prefill)[..., :v].abs().max()) <= LOGIT_TOL


def _meta_mesh():
    return dryrun.meta_mesh(shape=(1, 1))


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_build_cell_fn_builds_every_cell_on_a_meta_mesh(name):
    """Every cell of ``cells()``: at full depth the arguments have the
    reference's input shapes (``input_specs``: ids or bf16 frames, the decode
    token against ``init_cache(B, S)``, whose shapes are the reference's);
    cut to one layer group, ``fn(*args)`` runs on ``meta`` and returns the
    cell's outputs: the next state and the metrics, or last-position logits
    (and the cache)."""
    cfg = configs.get_config(name)
    rcfg = ref_configs.ARCHS[name]
    mesh = _meta_mesh()
    kinds = []
    for spec in configs.cells(cfg):
        b, s = spec.global_batch, spec.seq_len
        fn, args = build_cell_fn(cfg, spec, mesh, microbatches=1)
        embeds = cfg.frontend != "none"
        assert all(t.device.type == "meta" for t in tree_leaves(list(args[:2])))
        if spec.kind == "train":
            state, tok, tgt = args
            assert fn.microbatches == 1 and int(state.opt.step.numel()) == 1
            assert tgt.shape == (b, s)
        else:
            tok = args[1]
        if spec.kind == "decode":
            assert tok.shape == (b, 1) and args[3] == s - 1
            want = jax.eval_shape(lambda: RefLM(rcfg).init_cache(b, s))
            assert [tuple(x.shape) for x in jax.tree.leaves(want)] == \
                [tuple(x.shape) for x in tree_leaves(args[2])]
        else:
            assert tok.shape == ((b, s, cfg.d_model) if embeds else (b, s))
            assert tok.dtype == (torch.bfloat16 if embeds else torch.int32)
        small = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
        fn, args = build_cell_fn(small, spec, mesh, microbatches=1)
        out = fn(*args)
        vp = padded_vocab(cfg)
        if spec.kind == "train":
            new, metrics = out
            assert metrics["loss"].shape == () and new.params["embed"].shape == (vp, cfg.d_model)
        elif spec.kind == "prefill":
            assert out.shape == (b, 1, vp)
        else:
            logits, cache = out
            assert logits.shape == (b, 1, vp) and cache is args[2]
        kinds.append(spec.kind)
    assert kinds[:2] == ["train", "prefill"]
    assert ("decode" in kinds) == (cfg.family != "encoder")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_fn_runs_each_kind_on_the_cpu(kind):
    """Reduced smollm-135m, B = 2, S = 64, on a mesh of the CPU: train takes
    a step from the seeded state (the same loss as ``LM.loss`` on the
    ``SyntheticTokens`` batch); prefill gives the forward's last-position
    logits; decode writes its token's k and v at S - 1 in place and gives
    the same logits as the cached forward."""
    cfg = configs.reduced(configs.get_config("smollm-135m"))
    spec = ShapeSpec("tiny", 64, 2, kind)
    mesh = make_mesh_for([CPU], shard_axes=("data", "model"), shape=(1, 1))
    fn, args = build_cell_fn(cfg, spec, mesh, seed=3)
    tok_np, tgt_np = SyntheticTokens(cfg.vocab_size, 64, 2, seed=3).host_batch(0)
    model = fn.model
    if kind == "train":
        state, tok, tgt = args
        assert torch.equal(tok, torch.from_numpy(np.ascontiguousarray(tok_np)))
        want = model.loss(state.params, tok, tgt)
        new, metrics = fn(*args)
        assert fn.microbatches == 2  # one row per data shard
        assert abs(float(metrics["loss"]) - float(want)) <= 1e-5
        assert int(new.opt.step) == 1
    elif kind == "prefill":
        params, tok = args
        got = fn(*args)
        assert torch.equal(got, model.forward(params, tok, last_only=True)[0])
    else:
        params, tok, cache, pos = args
        assert pos == 63 and int(tok[0, 0]) == int(tok_np[0, 63])
        fresh = model.init_cache(2, 64)
        want = model.forward(params, tok, cache=fresh, cache_pos=63)[0]
        logits, out = fn(*args)
        assert out is cache and torch.equal(logits, want)
        k = cache[0]["k"]
        assert float(k[:, :, :, 63].abs().max()) > 0 and float(k[:, :, :, :63].abs().max()) == 0


def test_input_specs_feed_frames_that_carry_the_ids():
    """A model fed embeddings (reduced hubert-xlarge) takes bf16 frames, the
    seeded table's row for each ``SyntheticTokens`` id; the targets are the
    ids shifted by one."""
    cfg = configs.reduced(configs.get_config("hubert-xlarge"))
    mesh = make_mesh_for([CPU], shard_axes=("data", "model"), shape=(1, 1))
    ins = input_specs(cfg, ShapeSpec("tiny", 32, 2, "prefill"), mesh, seed=5)
    tok_np, tgt_np = SyntheticTokens(cfg.vocab_size, 32, 2, seed=5).host_batch(0)
    tok = torch.from_numpy(np.ascontiguousarray(tok_np))
    assert ins["use_embeds"] and ins["tokens"].dtype == torch.bfloat16
    assert torch.equal(ins["tokens"], frame_embeddings(cfg, tok, 5))
    assert torch.equal(ins["targets"], torch.from_numpy(np.ascontiguousarray(tgt_np)))


def test_roofline_cell_takes_the_reference_variants_and_puts_the_settings_back():
    """``variant`` has the reference's keys with the values passed; the
    microbatches reach the proof, a bfloat16 accumulator halves its bytes in
    the state, and the CP route counts fewer FLOPs than one call (its chunk
    pairs skip the causal upper half); ``ops.ATTN_IMPL`` and
    ``GRAD_ACCUM_DTYPE`` are as before the call, also after one that
    raises."""
    keys = {"microbatches", "attn_impl", "grad_accum_dtype"}
    before = ops.ATTN_IMPL, ts.GRAD_ACCUM_DTYPE
    base = dryrun.roofline_cell("smollm-135m", "train_4k", calibrate=False)
    assert set(base["variant"]) == keys and set(base["variant"].values()) == {None}
    var = dryrun.roofline_cell("smollm-135m", "train_4k", calibrate=False, microbatches=4,
                               grad_accum_dtype="bfloat16")
    assert var["variant"] == {"microbatches": 4, "attn_impl": None,
                              "grad_accum_dtype": "bfloat16"}
    assert var["proof"]["microbatches"] == 4 and base["proof"]["microbatches"] == 16
    # a float32 accumulator holds 4 bytes a parameter, a bfloat16 one 2; the
    # moments 8
    n = dryrun.state_bytes_per_rank(configs.get_config("smollm-135m"),
                                    dryrun.meta_mesh())["moments"] / 8
    assert base["proof"]["state_bytes_per_rank_estimate"] - \
        var["proof"]["state_bytes_per_rank_estimate"] == pytest.approx(2 * n)
    assert (ops.ATTN_IMPL, ts.GRAD_ACCUM_DTYPE) == before
    mesh = dryrun.meta_mesh(shape=(1, CP_SHARDS))
    one = dryrun.roofline_cell("smollm-135m", "train_4k", skip_proof=True, mesh=mesh)
    cpz = dryrun.roofline_cell("smollm-135m", "train_4k", skip_proof=True, mesh=mesh,
                               attn_impl="cp_zigzag")
    assert "proof" not in cpz and cpz["variant"]["attn_impl"] == "cp_zigzag"
    assert 0 < cpz["roofline"]["flops_per_chip"] < one["roofline"]["flops_per_chip"]
    assert (ops.ATTN_IMPL, ts.GRAD_ACCUM_DTYPE) == before
    with pytest.raises(ValueError, match="'model' axis"):
        dryrun.roofline_cell("smollm-135m", "train_4k", skip_proof=True,
                             mesh=_meta_mesh(), attn_impl="cp_zigzag",
                             grad_accum_dtype="bfloat16")
    assert (ops.ATTN_IMPL, ts.GRAD_ACCUM_DTYPE) == before


def test_memory_estimate_counts_k5_scratch_and_the_fill_block_by_hand(monkeypatch):
    """mamba2-370m's prefill at B = 8, S = 32,768 (32 heads of 64, state
    128, one group, chunk 128: 256 chunks) counts K5's scratch, 4 bytes x 8
    x (32 x 32,768 + 32 x 256 x 64 x 128 + 256 x 128²) = 2,315,255,808, the
    SSM mixer's activations a token, the last rows' logits (10 bytes x 8 x
    50,304), the cuBLAS workspace (32 MiB) and the float32 copy of the
    output projection (4 x 2,048 x 1,024); a
    smollm-135m decode cell at B = 8 filled in chunks of 2,048 adds 2,047 more
    queries' activations, 8 x 2,047 x (12 x 576 + 3 x 1,536) x 2 bytes, their
    (query, key) block, 12 bytes x 8 x 9 heads x 2,047 x 32,768, and their
    logits, 10 bytes x 8 x 2,047 x 49,152."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    mesh = _meta_mesh()
    mamba = configs.get_config("mamba2-370m")
    spec = dataclasses.replace(SHAPES["prefill_32k"], global_batch=8)
    assert dryrun.ssd_workspace_bytes(mamba, 8, 32768) == 2_315_255_808
    assert dryrun.ssd_workspace_bytes(configs.get_config("smollm-135m"), 8, 32768) == 0
    est = dryrun.memory_estimate(mamba, spec, mesh, 1)
    # a token's bf16 projection (2 x 2048 + 2 x 128 + 32 wide) and six
    # float32 (2048) tensors of the mixer
    tokens = 8 * 32768 * (2 * 4384 + 4 * 6 * 2048)
    fixed = 10 * 8 * 50304 + 32 * 2 ** 20 + 4 * 2048 * 1024
    assert est["activation_bytes_per_rank_estimate"] == tokens + 2_315_255_808 + fixed
    smol = configs.get_config("smollm-135m")
    spec = dataclasses.replace(SHAPES["decode_32k"], global_batch=8)
    one = dryrun.memory_estimate(smol, spec, mesh, 1)
    fill = dryrun.memory_estimate(smol, spec, mesh, 1, fill_chunk=2048)
    extra = (8 * 2047 * (12 * 576 + 3 * 1536) * 2 + 12 * 8 * 9 * 2047 * 32768
             + 10 * 8 * 2047 * 49152)
    assert fill["fill_chunk"] == 2048 and "fill_chunk" not in one
    assert fill["peak_bytes_per_rank_estimate"] - one["peak_bytes_per_rank_estimate"] == extra
    assert fill["state_bytes_per_rank_estimate"] == one["state_bytes_per_rank_estimate"]


def test_roofline_variants_survive_the_json_of_the_cli(tmp_path):
    """The CLI writes the default variant, the reference's keys, as JSON."""
    dryrun.main(["--arch", "mamba2-370m", "--shape", "prefill_32k", "--no-calibrate",
                 "--out", str(tmp_path)])
    res = json.loads((tmp_path / "mamba2-370m_prefill_32k_single.json").read_text())
    assert res["status"] == "ok"
    assert res["variant"] == {"microbatches": None, "attn_impl": None,
                              "grad_accum_dtype": None}
    assert res["proof"]["activation_bytes_per_rank_estimate"] > dryrun.ssd_workspace_bytes(
        configs.get_config("mamba2-370m"), 2, 32768)


def test_remat_recompute_takes_the_forwards_cp_route_on_another_thread(monkeypatch):
    """A CP-routed loss (reduced smollm-135m, S = 2112, the first multiple
    of 32 past S·T > 2048², remat full) whose backward runs on another
    thread after the route was put back, as autograd runs a CUDA backward
    on a device thread of its own where the forward's ambient mesh is not
    set: the recompute takes the forward's route (a CP call a layer again)
    and the gradients are bitwise those of a backward inside the route."""
    import threading

    cfg = configs.reduced(configs.get_config("smollm-135m"))
    model = LM(cfg, device="cpu", remat="full")
    params = model.init(0)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 2113)))
    calls = []
    real = cp.cp_zigzag_attention
    monkeypatch.setattr(cp, "cp_zigzag_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def cp_loss():
        with set_mesh(_cp_mesh()):
            monkeypatch.setattr(ops, "ATTN_IMPL", "cp_zigzag")
            try:
                return model.loss(params, tok[:, :-1], tok[:, 1:])
            finally:
                monkeypatch.setattr(ops, "ATTN_IMPL", "chunked")

    with set_mesh(_cp_mesh()):
        monkeypatch.setattr(ops, "ATTN_IMPL", "cp_zigzag")
        want = torch.autograd.grad(model.loss(params, tok[:, :-1], tok[:, 1:]), leaves)
        monkeypatch.setattr(ops, "ATTN_IMPL", "chunked")
    calls.clear()
    value = cp_loss()
    assert len(calls) == cfg.num_layers and ops.ATTN_IMPL == "chunked"
    got = []
    worker = threading.Thread(target=lambda: got.extend(torch.autograd.grad(value, leaves)))
    worker.start()
    worker.join()
    assert len(calls) == 2 * cfg.num_layers
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
