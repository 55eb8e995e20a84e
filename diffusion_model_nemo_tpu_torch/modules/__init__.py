from .autoencoder import AutoencoderKL, diagonal_gaussian_kl, diagonal_gaussian_sample
from .consistency_sampler import ConsistencySampler
from .diffusion_process import AbstractDiffusionProcess
from .dit import DiT
from .dpm_solver import DPMSolverDiffusion
from .edm_diffusion import EDMProcess
from .gaussian_diffusion import GaussianDiffusion
from .generalized_gaussian_diffusion import GeneralizedGaussianDiffusion
from .karras_diffusion import KarrasDiffusion
from .learned_gaussian_diffusion import LearnedGaussianDiffusion
from .rectified_flow import RectifiedFlowProcess
from .repaint import repaint_loop, repaint_schedule
from .sde_lib import VESDE, VPSDE, LikelihoodEstimate, subVPSDE
from .sde_samplers import PredictorCorrectorSampler, ProbabilityFlowSampler
from .unet import Unet, WaveGradUNet
from .unipc import UniPCDiffusion
from .wavegrad_audio import WaveGradVocoder
from .wavegrad_diffusion import WaveGradDiffusion

__all__ = [
    "AbstractDiffusionProcess",
    "AutoencoderKL",
    "ConsistencySampler",
    "DiT",
    "DPMSolverDiffusion",
    "EDMProcess",
    "GaussianDiffusion",
    "GeneralizedGaussianDiffusion",
    "KarrasDiffusion",
    "LearnedGaussianDiffusion",
    "LikelihoodEstimate",
    "PredictorCorrectorSampler",
    "ProbabilityFlowSampler",
    "RectifiedFlowProcess",
    "UniPCDiffusion",
    "Unet",
    "VESDE",
    "VPSDE",
    "WaveGradDiffusion",
    "WaveGradUNet",
    "WaveGradVocoder",
    "diagonal_gaussian_kl",
    "diagonal_gaussian_sample",
    "repaint_loop",
    "repaint_schedule",
    "subVPSDE",
]
