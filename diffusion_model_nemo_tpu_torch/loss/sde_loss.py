"""Continuous (denoising) score-matching loss of a score SDE.

Counterpart of ``diffusion_model_nemo_tpu/loss/sde_loss.py``: t ~ U[0, 1)
comes in and is rescaled to [eps, T]; x is perturbed along the SDE's
marginal with the caller's noise; the score (``resolve_score_function``)
is held to −z/std, weighted by std² (``likelihood_weighting=False``) or by
g(t)² (``True``); the reductions are ``mean``, ``batch_mean`` (sum per
sample), ``sum`` (half the sum per sample) and none, then the batch mean.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..config.registry import register_target
from ..modules.sde_lib.score_fn import resolve_score_function
from ..modules.sde_lib.sde_lib import SDE, batch_mul

__all__ = ["SDEScoreFunctionLoss", "resolve_score_function"]


@register_target("diffusion_model_nemo.loss.SDEScoreFunctionLoss")
class SDEScoreFunctionLoss:
    def __init__(
        self,
        continuous: bool = True,
        likelihood_weighting: bool = True,
        eps: float = 1e-5,
        reduction: str = "mean",
    ):
        self.continuous = continuous
        self.likelihood_weighting = likelihood_weighting
        self.eps = eps
        self.reduction = reduction
        self.sde: Optional[SDE] = None

    def update_sde(self, sde: SDE) -> None:
        self.sde = sde

    resolve_score_function = staticmethod(resolve_score_function)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduction == "batch_mean":
            return x.reshape(x.shape[0], -1).sum(-1)
        if self.reduction == "mean":
            return x.reshape(x.shape[0], -1).mean(-1)
        if self.reduction == "sum":
            return 0.5 * x.reshape(x.shape[0], -1).sum(-1)
        return x

    def __call__(self, model_fn, params: Any, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The batch's loss; ``t`` [B] uniform in [0, 1), ``noise`` like x."""
        if self.sde is None:
            raise RuntimeError("Must set the SDE solver via `update_sde()` !")
        sde = self.sde
        t = t * (sde.T - self.eps) + self.eps
        score_fn = resolve_score_function(model_fn, sde=sde, continuous=self.continuous)
        mean, std = sde.marginal_prob(x_start, t)
        perturbed_data = mean + batch_mul(std, noise)
        score = score_fn(params, perturbed_data, t)
        if not self.likelihood_weighting:
            losses = self._reduce(torch.square(batch_mul(std, score) + noise))
        else:
            g2 = sde.sde(torch.zeros_like(x_start), t)[1] ** 2
            losses = self._reduce(torch.square(score + batch_mul(1.0 / std, noise))) * g2
        return losses.mean()
