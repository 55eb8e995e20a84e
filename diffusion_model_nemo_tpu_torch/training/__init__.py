from .ema import ema_decay_at, ema_update, init_ema
from .optim import Optimizer, build_lr_schedule, build_optimizer, clip_by_global_norm, global_norm
from .trainer import Trainer, TrainState

__all__ = [
    "Optimizer",
    "Trainer",
    "TrainState",
    "build_lr_schedule",
    "build_optimizer",
    "clip_by_global_norm",
    "ema_decay_at",
    "ema_update",
    "global_norm",
    "init_ema",
]
