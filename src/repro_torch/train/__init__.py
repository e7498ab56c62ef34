"""Training for the port: AdamW and its schedule, data, checkpoints, fault
tolerance, the LM train step, and the semi-supervised HGNN step on either
NA executor with ``fit`` (the JAX package's ``repro.train``)."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.train_step import TrainState, build_train_step
# NOTE: the package-level `init_train_state` is the HGNN variant (it
# returns HGNNTrainState, pairing with make_train_step/fit), as in the JAX
# package.  The LM variant that pairs with `build_train_step` lives at
# repro_torch.train.train_step.init_train_state: import it from there.
# `init_hgnn_train_state` is the unambiguous alias.
from repro_torch.train.hgnn_step import (HGNNTrainState, degree_bucket_labels,
                                         fit, init_train_state)
from repro_torch.train.hgnn_step import init_train_state as init_hgnn_train_state
from repro_torch.train.hgnn_step import (make_eval_fn, make_train_step,
                                         propagated_feature_labels,
                                         semi_supervised_masks,
                                         train_state_from_numpy, value_and_grad)
from repro_torch.train.optim import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, warmup_cosine)
from repro_torch.train.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = [
    "AdamWState", "CheckpointManager", "HGNNTrainState", "SyntheticTokens",
    "TrainState", "adamw_init", "adamw_update", "build_train_step",
    "clip_by_global_norm", "degree_bucket_labels", "fit", "init_hgnn_train_state",
    "init_train_state", "make_eval_fn", "make_train_step",
    "propagated_feature_labels", "semi_supervised_masks",
    "train_state_from_numpy", "tree_flatten", "tree_leaves", "tree_map",
    "tree_unflatten", "value_and_grad", "warmup_cosine",
]
