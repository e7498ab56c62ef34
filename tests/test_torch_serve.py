"""Port serving parity: ``repro_torch.serve.engine.ServeEngine`` on the CPU
against the JAX package's engine on ``tests/test_serve.py``'s set-up
(reduced smollm-135m, reference parameters carried across), its two
reference faults included; plus slot reuse, prefix grouping and the
serving command line."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import make_model as ref_make_model  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.engine import \
    _prefix_group_order as ref_group_order  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.lm import LM, lm_params_from_numpy  # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,  # noqa: E402
                                      _prefix_group_order)

# a differing token is allowed only where the reference's top two logits
# lie within the decode-vs-forward tolerance (tests/test_models_lm.py:80)
LOGIT_TOL = 5e-2


def _engines(arch, slots, max_len):
    cfg = reduced(ARCHS[arch])
    ref_model = ref_make_model(cfg, backend="interpret", remat="none")
    params = ref_model.init(jax.random.key(0))
    ref = RefEngine(ref_model, params, slots, max_len)
    port = ServeEngine(LM(cfg, device="cpu"),
                       lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                       slots, max_len)
    return cfg, ref, port


def _record_step_logits(eng):
    """Wrap a reference engine so each ``step`` records ``(rid per slot,
    last-position logits)``."""
    steps, last = [], [None]
    decode, step = eng._decode, eng.step

    def rec_decode(*args):
        out = decode(*args)
        last[0] = np.asarray(out[0])[:, -1]
        return out

    def rec_step(*args, **kw):
        rids = [r.rid if r is not None else None for r in eng.live]
        res = step(*args, **kw)
        steps.append((rids, last[0]))
        return res

    eng._decode, eng.step = rec_decode, rec_step
    return steps


def _requests(cls, cfg, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
                max_new=max_new) for i in range(n)]


def _assert_same_tokens(done_ref, done_port, steps):
    """Equal tokens, except after a step where the reference's top two
    logits for that request were within LOGIT_TOL."""
    assert set(done_port) == set(done_ref)
    per_rid = {}
    for rids, logits in steps:
        for s, rid in enumerate(rids):
            if rid is not None:
                per_rid.setdefault(rid, []).append(logits[s])
    for rid, want in done_ref.items():
        got = done_port[rid]
        assert len(got) == len(want)
        for j, (a, b) in enumerate(zip(got, want)):
            if a != b:
                top2 = np.sort(per_rid[rid][j])[-2:]
                assert top2[1] - top2[0] < LOGIT_TOL, (rid, j, a, b, top2)
                break  # the request's later tokens follow its own history


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_serve_matches_reference_engine(arch):
    cfg, ref, port = _engines(arch, slots=2, max_len=32)
    steps = _record_step_logits(ref)
    done_ref = ref.run(_requests(RefRequest, cfg, 5, 4, 4, seed=0), max_steps=64)
    done_port = port.run(_requests(Request, cfg, 5, 4, 4, seed=0), max_steps=64)
    assert set(done_port) == {0, 1, 2, 3, 4}
    assert all(len(v) == 4 for v in done_port.values())
    assert all(0 <= t < cfg.vocab_size for v in done_port.values() for t in v)
    _assert_same_tokens(done_ref, done_port, steps)
    # the caches end equal too: the prefill fault (every slot's row written
    # while one slot prefills) is reproduced, not repaired
    for a, b in zip(jax.tree.leaves(ref.cache), jax.tree.leaves(port.cache)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=3e-2)
    assert np.array_equal(port.pos, ref.pos)


def test_prefill_writes_every_slot_like_the_reference():
    """Admitting into slot 1 overwrites slot 0's cache rows 0..P-1 with the
    k/v of token id 0 (the other slots' filler token in the prefill's
    decode batch): the reference's fault, ROADMAP queue 3."""
    cfg, ref, port = _engines("smollm-135m", slots=2, max_len=16)
    prompt = np.arange(1, 5, dtype=np.int32)
    port._prefill(1, Request(rid=0, prompt=prompt))
    ref._prefill(1, RefRequest(rid=0, prompt=prompt))
    k_port = port.cache[0]["k"].float().numpy()
    assert np.abs(k_port[:, 0, :, :4]).min(axis=-1).max() > 0  # slot 0 written
    assert not k_port[:, :, :, 4:].any()  # nothing past the prompt
    np.testing.assert_allclose(k_port, np.asarray(ref.cache[0]["k"], np.float32),
                               atol=3e-2)


def test_slot_reuse_continuous_batching():
    cfg, ref, port = _engines("smollm-135m", slots=1, max_len=32)
    steps = _record_step_logits(ref)
    done_ref = ref.run(_requests(RefRequest, cfg, 3, 3, 2, seed=1), max_steps=64)
    done_port = port.run(_requests(Request, cfg, 3, 3, 2, seed=1), max_steps=64)
    assert set(done_port) == {0, 1, 2}  # one slot served all three in turn
    _assert_same_tokens(done_ref, done_port, steps)


def test_prefix_grouping_order_matches_reference():
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 100, 8)
    prompts = [(shared.copy() if i % 2 == 0 else rng.integers(0, 100, 8)).astype(np.int32)
               for i in range(6)]
    ordered = _prefix_group_order([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    want = ref_group_order([RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert [r.rid for r in ordered] == [r.rid for r in want]
    pos = [i for i, r in enumerate(ordered) if r.rid % 2 == 0]
    assert pos == list(range(pos[0], pos[0] + 3))


def test_serve_cli_on_the_cpu(capsys):
    serve_cli.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "on cpu" in out
    reqs = serve_cli.make_requests(512, 4, 6, 8)
    assert np.array_equal(reqs[0].prompt[:-1], reqs[2].prompt[:-1])


def test_serve_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "smollm-135m", "--reduced"])
