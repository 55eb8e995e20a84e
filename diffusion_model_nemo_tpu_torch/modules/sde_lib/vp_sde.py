"""Variance-preserving SDE (Song et al. 2021).

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/vp_sde.py``: the
discrete DDPM tables are built in float64 with numpy and cast to float32,
as in the JAX package, and exposed as both ``betas`` and
``discrete_betas`` (the name the ancestral predictor reads).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ...config.registry import register_target
from .sde_lib import SDE, batch_mul, gaussian_prior_logp, take

__all__ = ["VPSDE"]


def log_mean_coeff(sde, t: torch.Tensor) -> torch.Tensor:
    """log of the marginal mean's scale at t (VP and sub-VP)."""
    return -0.25 * t**2 * (sde.beta_1 - sde.beta_0) - 0.5 * t * sde.beta_0


@register_target("diffusion_model_nemo.modules.VPSDE", "diffusion_model_nemo.modules.sde_lib.VPSDE")
class VPSDE(SDE):
    sampling_epsilon = 1e-3

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20, N: int = 1000,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(N, device)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        self.compute_constants(N)

    def compute_constants(self, timesteps: int) -> None:
        """The discrete tables, float64 on the host, stored as float32."""
        betas = np.linspace(self.beta_0 / timesteps, self.beta_1 / timesteps, timesteps, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.betas = f32(betas)
        self.discrete_betas = self.betas
        self.alphas = f32(alphas)
        self.alphas_cumprod = f32(alphas_cumprod)
        self.sqrt_alphas_cumprod = torch.sqrt(self.alphas_cumprod)
        self.sqrt_1m_alphas_cumprod = torch.sqrt(1.0 - self.alphas_cumprod)

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        drift = -0.5 * batch_mul(beta_t, x)
        diffusion = torch.sqrt(beta_t)
        return drift, diffusion

    def marginal_prob(self, x, t):
        lmc = log_mean_coeff(self, t)
        mean = batch_mul(torch.exp(lmc), x)
        std = torch.sqrt(1.0 - torch.exp(2.0 * lmc))
        return mean, std

    def prior_logp(self, z):
        return gaussian_prior_logp(z)

    def discretize(self, x, t):
        """The DDPM discretization: x·√α_i − x and √β_i at i = int(t(N−1)/T)."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int32)
        beta = take(self.betas, timestep)
        alpha = take(self.alphas, timestep)
        f = batch_mul(torch.sqrt(alpha), x) - x
        G = torch.sqrt(beta)
        return f, G
