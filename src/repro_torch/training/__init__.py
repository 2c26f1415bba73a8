from .optimizer import (OptimizerConfig, adamw_init, adamw_update,
                        lr_schedule)
from .train_step import TrainConfig, make_train_step, remat_policy_by_name

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "lr_schedule",
           "TrainConfig", "make_train_step", "remat_policy_by_name"]
