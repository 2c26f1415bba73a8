from .optimizer import (OptimizerConfig, adamw_init, adamw_update,
                        adamw_update_, lr_schedule)
from .train_step import (TrainConfig, jit_train_step, make_train_step,
                         remat_policy_by_name)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "adamw_update_",
           "lr_schedule", "TrainConfig", "jit_train_step", "make_train_step",
           "remat_policy_by_name"]
