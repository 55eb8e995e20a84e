from .diffusion_process import AbstractDiffusionProcess
from .dit import DiT
from .gaussian_diffusion import GaussianDiffusion
from .generalized_gaussian_diffusion import GeneralizedGaussianDiffusion
from .learned_gaussian_diffusion import LearnedGaussianDiffusion
from .sde_lib import VESDE, VPSDE, LikelihoodEstimate, subVPSDE
from .sde_samplers import PredictorCorrectorSampler, ProbabilityFlowSampler
from .unet import Unet

__all__ = [
    "AbstractDiffusionProcess",
    "DiT",
    "GaussianDiffusion",
    "GeneralizedGaussianDiffusion",
    "LearnedGaussianDiffusion",
    "LikelihoodEstimate",
    "PredictorCorrectorSampler",
    "ProbabilityFlowSampler",
    "Unet",
    "VESDE",
    "VPSDE",
    "subVPSDE",
]
