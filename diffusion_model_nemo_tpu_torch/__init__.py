"""PyTorch/CUDA port of diffusion_model_nemo_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax`` or the JAX package. Its entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CUDA the U-Net runs through
hand-written Hopper kernels (``csrc/``, built at first use by
``ops/_build.py``), on the CPU through their plain PyTorch versions.
"""

from . import config, models, modules, ops, serving, utils
from .models import DDPM

__all__ = ["config", "models", "modules", "ops", "serving", "utils", "DDPM"]
