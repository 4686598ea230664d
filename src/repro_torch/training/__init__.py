"""repro_torch.training — optimizer, train step, data pipeline."""
from .data import SyntheticLM
from .optimizer import (adamw_update, global_norm, init_opt_state, leaf_order,
                        loss_and_grads, lr_at, make_train_step,
                        opt_state_specs)
from .state import load_train_state, state_like, train_state

__all__ = ["adamw_update", "global_norm", "init_opt_state", "leaf_order",
           "load_train_state", "loss_and_grads", "lr_at", "make_train_step",
           "opt_state_specs", "state_like", "train_state", "SyntheticLM"]
