from .checkpoints import CheckpointManager, load_archive, load_aux_weights, save_archive
from .ema import ema_decay_at, ema_decay_table, ema_update, init_ema
from .exp_manager import ExpManagerHooks, exp_manager
from .optim import Optimizer, build_lr_schedule, build_optimizer, clip_by_global_norm, global_norm
from .posthoc_ema import PostHocEMA
from .posthoc_ema import reconstruct as reconstruct_posthoc_ema
from .reflow import ReflowState, ReflowTrainer
from .trainer import Trainer, TrainState

__all__ = [
    "CheckpointManager",
    "ExpManagerHooks",
    "Optimizer",
    "PostHocEMA",
    "ReflowState",
    "ReflowTrainer",
    "Trainer",
    "TrainState",
    "build_lr_schedule",
    "build_optimizer",
    "clip_by_global_norm",
    "ema_decay_at",
    "ema_decay_table",
    "ema_update",
    "exp_manager",
    "global_norm",
    "init_ema",
    "load_archive",
    "load_aux_weights",
    "reconstruct_posthoc_ema",
    "save_archive",
]
