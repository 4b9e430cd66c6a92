from repro_torch.train.optimizer import (
    adamw_init, adamw_update, adafactor_init, adafactor_update,
    cosine_schedule, clip_by_global_norm,
)
from repro_torch.train.train_step import make_train_step, make_eval_step

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "cosine_schedule", "clip_by_global_norm", "make_train_step", "make_eval_step",
]
