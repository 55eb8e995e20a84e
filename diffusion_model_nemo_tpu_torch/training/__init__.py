from .checkpoints import CheckpointManager, load_archive, load_aux_weights, save_archive
from .consistency import ConsistencyDistiller, ConsistencyState
from .distillation import DistillState, ProgressiveDistiller, predict_eps_x0
from .ema import ema_decay_at, ema_decay_table, ema_update, init_ema
from .exp_manager import ExpManagerHooks, exp_manager
from .lora import LoRAFinetuner, load_adapters, lora_init, merge_adapters, save_adapters
from .optim import Optimizer, build_lr_schedule, build_optimizer, clip_by_global_norm, global_norm
from .posthoc_ema import PostHocEMA
from .posthoc_ema import reconstruct as reconstruct_posthoc_ema
from .reflow import ReflowState, ReflowTrainer
from .trainer import Trainer, TrainState

__all__ = [
    "CheckpointManager",
    "ConsistencyDistiller",
    "ConsistencyState",
    "DistillState",
    "ExpManagerHooks",
    "LoRAFinetuner",
    "Optimizer",
    "PostHocEMA",
    "ProgressiveDistiller",
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
    "lora_init",
    "load_adapters",
    "load_archive",
    "load_aux_weights",
    "merge_adapters",
    "predict_eps_x0",
    "reconstruct_posthoc_ema",
    "save_adapters",
    "save_archive",
]
