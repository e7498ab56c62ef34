"""Config-driven LM zoo (PyTorch): the serving path of the JAX package's
``repro.models`` for every architecture — prefill through the K4 / K5
kernels, decode with a stacked cache.  The loss comes with the LM training
slice."""
from repro_torch.models.lm import (LM, init_params, lm_params_from_numpy,
                                   make_model, padded_vocab)

__all__ = ["LM", "init_params", "lm_params_from_numpy", "make_model", "padded_vocab"]
