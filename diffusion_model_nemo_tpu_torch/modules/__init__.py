from .diffusion_process import AbstractDiffusionProcess
from .dit import DiT
from .gaussian_diffusion import GaussianDiffusion
from .generalized_gaussian_diffusion import GeneralizedGaussianDiffusion
from .learned_gaussian_diffusion import LearnedGaussianDiffusion
from .unet import Unet

__all__ = [
    "AbstractDiffusionProcess",
    "DiT",
    "GaussianDiffusion",
    "GeneralizedGaussianDiffusion",
    "LearnedGaussianDiffusion",
    "Unet",
]
