"""The ``model:`` section of ``examples/configs/dit/dit_small.yaml`` as a
Python dict, with ``image_size: 64`` and its ``${...}`` references resolved.

DiT-S/2: dim 384, depth 12, 6 heads of 64, patch 2, MLP ratio 4, a 256-wide
time sinusoid, bf16 compute with f32 params, cosine schedule over T = 1000
with ε-prediction. At 64×64 pixels the 2×2 patches make N = 1024 tokens,
the first size at which the JAX package's dispatch sends the attention core
to its kernel (and the port to its Hopper kernel).
"""

from __future__ import annotations

import copy

__all__ = ["DIT_SMALL_MODEL", "dit_small_model_config"]

DIT_SMALL_MODEL = {
    "image_size": 64,
    "timesteps": 1000,
    "channels": 3,
    "num_classes": None,
    "save_every": 1000,
    "compute_bpd": True,
    "train_ds": {
        "name": None,
        "split": None,
        "cache_dir": None,
        "batch_size": 128,
        "shuffle": True,
        "num_workers": 4,
        "pin_memory": True,
    },
    "diffusion_model": {
        "_target_": "diffusion_model_nemo.modules.DiT",
        "input_dim": 64,
        "channels": 3,
        "num_classes": None,
        "dim": 384,
        "depth": 12,
        "heads": 6,
        "patch_size": 2,
        "mlp_ratio": 4.0,
        "time_freq_dim": 256,
        "out_dim": None,
        "learned_variance": False,
        "dropout": 0.0,
        "moe_experts": 0,
        "moe_every": 2,
        "moe_capacity_factor": 1.0,
        "dtype": "bfloat16",
    },
    "sampler": {
        "_target_": "diffusion_model_nemo.modules.GaussianDiffusion",
        "timesteps": 1000,
        "schedule_name": "cosine",
        "schedule_cfg": {
            "cosine": {"s": 0.008, "min_clip": 0.0001, "max_clip": 0.999},
            "linear": {"beta_start": 0.0001, "beta_end": 0.02},
            "quadratic": {"beta_start": 0.0001, "beta_end": 0.02},
            "sigmoid": {"beta_start": 0.0001, "beta_end": 0.02},
        },
    },
    "loss": {
        "_target_": "diffusion_model_nemo.loss.DiffusionLoss",
        "loss_type": "l2",
        "reduction": "mean",
    },
    "optim": {
        "name": "adamw",
        "lr": 0.0001,
        "betas": [0.9, 0.999],
        "weight_decay": 0.0,
        "sched": {
            "name": "CosineAnnealing",
            "warmup_steps": None,
            "warmup_ratio": None,
            "min_lr": 1e-5,
        },
    },
}


def dit_small_model_config(**overrides) -> dict:
    """A fresh copy of :data:`DIT_SMALL_MODEL` with top-level overrides."""
    cfg = copy.deepcopy(DIT_SMALL_MODEL)
    cfg.update(overrides)
    return cfg
