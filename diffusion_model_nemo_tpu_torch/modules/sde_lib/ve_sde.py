"""Variance-exploding SDE (NCSN / SMLD).

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/ve_sde.py``; the
discrete σ table is e^{linspace(log σ_min, log σ_max, N)} on JAX's float32
grid.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from ...config.registry import register_target
from .sde_lib import SDE, gaussian_prior_logp, jax_linspace, take

__all__ = ["VESDE"]


def adjacent(table: torch.Tensor, timestep: torch.Tensor, t: torch.Tensor):
    """(table[i], table[i − 1] or 0 where i = 0)."""
    prev = take(table, (timestep - 1).clamp(min=0))
    return take(table, timestep), torch.where(timestep == 0, torch.zeros_like(t), prev)


@register_target("diffusion_model_nemo.modules.VESDE", "diffusion_model_nemo.modules.sde_lib.VESDE")
class VESDE(SDE):
    sampling_epsilon = 1e-5

    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 50, N: int = 1000,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(N, device)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.prior_std = self.sigma_max
        grid = jax_linspace(math.log(self.sigma_min), math.log(self.sigma_max), N)
        self.discrete_sigmas = torch.exp(torch.from_numpy(grid)).to(self.device)

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        drift = torch.zeros_like(x)
        diffusion = sigma * float(np.sqrt(np.float32(2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))))
        return drift, diffusion

    def marginal_prob(self, x, t):
        std = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return x, std

    def prior_logp(self, z):
        return gaussian_prior_logp(z, self.sigma_max)

    def discretize(self, x, t):
        """SMLD discretization with the adjacent σ."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int32)
        sigma, adjacent_sigma = adjacent(self.discrete_sigmas, timestep, t)
        f = torch.zeros_like(x)
        G = torch.sqrt(sigma**2 - adjacent_sigma**2)
        return f, G
