"""HGNN training for the port: AdamW and its schedule, the
semi-supervised train step on either NA executor, ``fit`` and its
checkpoints (the JAX package's ``repro.train`` minus the LM pieces, which
are ROADMAP M12b)."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.hgnn_step import (HGNNTrainState, degree_bucket_labels,
                                         fit, init_train_state, make_eval_fn,
                                         make_train_step,
                                         propagated_feature_labels,
                                         semi_supervised_masks,
                                         train_state_from_numpy, value_and_grad)
from repro_torch.train.optim import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, warmup_cosine)
from repro_torch.train.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = [
    "AdamWState", "CheckpointManager", "HGNNTrainState", "adamw_init",
    "adamw_update", "clip_by_global_norm", "degree_bucket_labels", "fit",
    "init_train_state", "make_eval_fn", "make_train_step",
    "propagated_feature_labels", "semi_supervised_masks",
    "train_state_from_numpy", "tree_flatten", "tree_leaves", "tree_map",
    "tree_unflatten", "value_and_grad", "warmup_cosine",
]
