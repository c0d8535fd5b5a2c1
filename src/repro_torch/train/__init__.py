from repro_torch.train.optimizer import adamw_init, adamw_update, cosine_schedule
from repro_torch.train.step import make_train_step

__all__ = ["adamw_init", "adamw_update", "cosine_schedule",
           "make_train_step"]
