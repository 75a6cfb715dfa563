"""LM training of the port (counterpart of `repro.train`): AdamW and its
schedules, the train and MVS steps, checkpoints in the reference's format."""
from repro_torch.train.optimizer import AdamWState, OptConfig, adamw_init, adamw_update, lr_at
from repro_torch.train.train_step import TrainConfig, make_train_step, make_mvs_train_step
from repro_torch.train.checkpoint import save_checkpoint, restore_checkpoint

__all__ = [
    "AdamWState",
    "OptConfig",
    "adamw_init",
    "adamw_update",
    "lr_at",
    "TrainConfig",
    "make_train_step",
    "make_mvs_train_step",
    "save_checkpoint",
    "restore_checkpoint",
]
