"""EDM training loss (Karras et al. 2022, eq. 2 and Table 1).

Counterpart of ``diffusion_model_nemo_tpu/loss/edm_loss.py``: the
λ(σ)-weighted D-space MSE ``λ(σ)·(D(x0 + σε; σ) − x0)²`` in float32, λ(σ) =
(σ² + σ_d²)/(σ·σ_d)², with the reductions of ``DiffusionLoss``; this is what
the JAX loss computes (its module docstrings name the F-space form, its
code takes the D-space one). With EDM's preconditioning λ·c_out² = 1, so
the same number is the unit-weight MSE of the raw network output F against
the effective target (x0 − c_skip·x)/c_out: ``f_space`` computes that form
(the identity is held in the tests).
"""

from __future__ import annotations

import torch

from ..config.registry import register_target

__all__ = ["EDMLoss"]

_REDUCTIONS = ("mean", "sum", "none", "batch_mean")


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "batch_mean":
        return loss.reshape(loss.shape[0], -1).sum(-1).mean()
    return loss


@register_target("diffusion_model_nemo.loss.EDMLoss", "diffusion_model_nemo_tpu.loss.EDMLoss")
class EDMLoss:
    def __init__(self, sigma_data: float = 0.5, reduction: str = "mean"):
        if reduction not in _REDUCTIONS:
            raise ValueError(f"Invalid reduction {reduction}")
        if float(sigma_data) <= 0.0:
            raise ValueError(f"sigma_data must be > 0, got {sigma_data}")
        self.sigma_data = float(sigma_data)
        self.reduction = reduction

    def weight(self, sigma: torch.Tensor) -> torch.Tensor:
        """λ(σ) = (σ² + σ_d²)/(σ·σ_d)² = 1/c_out², float32."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        return (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2

    def __call__(self, input: torch.Tensor, target: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """input = D(x_σ; σ), target = x0, sigma = [B] noise levels."""
        w = self.weight(sigma).reshape((-1,) + (1,) * (input.ndim - 1))
        return _reduce(w * (input.float() - target.float()) ** 2, self.reduction)

    def f_space(self, F: torch.Tensor, x_sigma: torch.Tensor, target: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
        """The same loss as the unit-weight MSE of the raw network output
        ``F`` against (x0 − c_skip·x_σ)/c_out."""
        s = torch.as_tensor(sigma, dtype=torch.float32).reshape((-1,) + (1,) * (F.ndim - 1))
        sd2 = self.sigma_data**2
        c_skip = sd2 / (s**2 + sd2)
        c_out = s * self.sigma_data * torch.rsqrt(s**2 + sd2)
        f_target = (target.float() - c_skip * x_sigma.float()) / c_out
        return _reduce((F.float() - f_target) ** 2, self.reduction)
