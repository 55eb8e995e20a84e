"""Sub-VP SDE (the likelihood-oriented variant of Song et al. 2021).

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/sub_vp_sde.py``;
its marginal "std" is 1 − e^{2·lmc}, as in the reference.
"""

from __future__ import annotations

from typing import Union

import torch

from ...config.registry import register_target
from .sde_lib import SDE, batch_mul, gaussian_prior_logp
from .vp_sde import log_mean_coeff

__all__ = ["subVPSDE"]


@register_target("diffusion_model_nemo.modules.subVPSDE", "diffusion_model_nemo.modules.sde_lib.subVPSDE")
class subVPSDE(SDE):
    sampling_epsilon = 1e-3

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20, N: int = 1000,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(N, device)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        drift = -0.5 * batch_mul(beta_t, x)
        discount = 1.0 - torch.exp(-2 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t**2)
        diffusion = torch.sqrt(beta_t * discount)
        return drift, diffusion

    def marginal_prob(self, x, t):
        lmc = log_mean_coeff(self, t)
        mean = batch_mul(torch.exp(lmc), x)
        std = 1.0 - torch.exp(2.0 * lmc)
        return mean, std

    def prior_logp(self, z):
        return gaussian_prior_logp(z)
