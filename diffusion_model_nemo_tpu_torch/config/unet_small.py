"""The ``model:`` section of ``examples/configs/ddpm/unet_small.yaml`` as a
Python dict, with ``image_size: 32`` and its ``${...}`` references resolved.

The reference's published DDPM configuration: dim 32, dim_mults [1, 2, 4, 8],
ResNet blocks with 8 GroupNorm groups in 'bn_act_conv' order, cosine
schedule over T = 1000 with ε-prediction, bf16 compute with f32 params.
"""

from __future__ import annotations

import copy

__all__ = ["UNET_SMALL_MODEL", "unet_small_model_config", "flagship_model_config"]

UNET_SMALL_MODEL = {
    "image_size": 32,
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
        "_target_": "diffusion_model_nemo.modules.Unet",
        "input_dim": 32,
        "dim": 32,
        "channels": 3,
        "num_classes": None,
        "dim_mults": [1, 2, 4, 8],
        "with_time_emb": True,
        "resnet_block_order": "bn_act_conv",
        "resnet_block_groups": 8,
        "use_convnext": False,
        "convnext_mult": 2,
        "out_dim": None,
        "dropout": 0.0,
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
        "lr": 0.001,
        "betas": [0.9, 0.98],
        "weight_decay": 0.001,
        "sched": {
            "name": "CosineAnnealing",
            "warmup_steps": None,
            "warmup_ratio": None,
            "min_lr": 1e-4,
        },
    },
}


def unet_small_model_config(**overrides) -> dict:
    """A fresh copy of :data:`UNET_SMALL_MODEL` with top-level overrides."""
    cfg = copy.deepcopy(UNET_SMALL_MODEL)
    cfg.update(overrides)
    return cfg


def flagship_model_config(dtype: str = "bfloat16") -> dict:
    """The JAX package's bench flagship (``__graft_entry__.py:_flagship``):
    unet_small with dim_mults [1, 2, 2, 2]."""
    cfg = unet_small_model_config()
    cfg["diffusion_model"]["dim_mults"] = [1, 2, 2, 2]
    cfg["diffusion_model"]["dtype"] = dtype
    return cfg
