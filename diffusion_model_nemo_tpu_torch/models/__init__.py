from .abstract_diffusion_model import AbstractDiffusionModel
from .ddpm import DDPM

__all__ = ["AbstractDiffusionModel", "DDPM"]
