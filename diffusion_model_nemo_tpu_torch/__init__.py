"""PyTorch/CUDA port of diffusion_model_nemo_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax`` or the JAX package. Its entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CUDA the U-Net runs through
hand-written Hopper kernels (``csrc/``, built at first use by
``ops/_build.py``), on the CPU through their plain PyTorch versions.
Training: ``Trainer(...).fit(DDPM(cfg))`` (``training/``); the model families
are ``DDPM``, ``ImprovedDDPM``, ``ConditionalDDPM``, ``ScoreSDE``,
``WavegradDDPM``, the mel → waveform ``WavegradVocoderModel``, ``EDM``,
``ConditionalEDM`` and the super-resolution ``SR3``, which
``pipelines.CascadePipeline`` chains behind a base generator.
"""

from . import config, data, loss, models, modules, ops, pipelines, serving, training, utils
from .models import (
    DDPM, EDM, SR3, ConditionalDDPM, ConditionalEDM, ImprovedDDPM, ScoreSDE, WavegradDDPM, WavegradVocoderModel,
)
from .training import Trainer

__all__ = [
    "config", "data", "loss", "models", "modules", "ops", "pipelines", "serving", "training", "utils",
    "DDPM", "ImprovedDDPM", "ConditionalDDPM", "ScoreSDE", "WavegradDDPM", "WavegradVocoderModel", "EDM",
    "ConditionalEDM", "SR3", "Trainer",
]
