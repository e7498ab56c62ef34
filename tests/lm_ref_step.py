"""The JAX package's LM train step body, for the port's step tests.

The reference's ``build_train_step`` fails to build on this JAX
(``tests/test_train.py``'s LM cases), so ``ref_step`` composes its step
from the reference's own pieces, in the same order, on one device: its
meaning, the loss and gradients of the whole global batch, is what every
mesh's step must give.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as ref_configs
import repro.train.compress as ref_compress
import repro.train.optim as ref_optim
from repro.models.lm import LM as RefLM


@functools.lru_cache(maxsize=None)
def ref_model(name: str, ssd_chunk: int = 128):
    """The reference's reduced ``name`` (jnp backend, no remat) and its
    parameters from ``jax.random.key(0)``, built once a process (JAX arrays
    are immutable)."""
    ref = RefLM(ref_configs.reduced(ref_configs.ARCHS[name]), backend="jnp", remat="none",
                ssd_chunk=ssd_chunk)
    return ref, ref.init(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def ref_step(ref, microbatches, use_compression, lr):
    """The body of the reference's ``build_train_step.step``
    (``repro/train/train_step.py:91-134``) without the mesh: the same
    pieces in the same order, the microbatch scan as a loop, compiled as
    one program (eager, its optimizer compiles op by op for seconds) and
    kept for every caller with the same arguments.
    ``step(params, opt, residuals, tok, tgt) -> (params, opt, residuals,
    loss, grad_norm)``."""
    def loss_fn(params, tok, tgt):
        return ref.loss(params, tok, tgt, aux_weight=0.01)

    vg = jax.value_and_grad(loss_fn)

    @jax.jit
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


def max_rel(a, b) -> float:
    """``max |a - b|`` over ``max |a|``: ``a`` a reference array, ``b`` the
    port's tensor."""
    a32, b32 = np.asarray(a, np.float32), b.float().numpy()
    return float(np.abs(a32 - b32).max() / max(np.abs(a32).max(), 1e-30))
