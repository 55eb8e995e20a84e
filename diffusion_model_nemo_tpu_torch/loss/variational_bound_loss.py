"""Variational-bound (VLB) loss terms, for learned-variance training and
bits/dim.

Counterpart of ``diffusion_model_nemo_tpu/loss/variational_bound_loss.py``:
the per-example term is ``KL(q(x_{t-1}|x_t,x₀) ‖ p_θ)/ln2`` for t > 0 and
the discretized-Gaussian decoder NLL at t = 0; ``weight`` (default 0.001)
scales the loss; ``detach_model_mean`` stops the gradient through the mean.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..config.registry import register_target
from ..ops.math import LOG2, discretized_gaussian_log_likelihood, mean_flattened, normal_kl

__all__ = ["VariationalBoundLoss", "compute_variational_loss_terms"]


def compute_variational_loss_terms(
    samples: torch.Tensor,
    model_mean: torch.Tensor,
    model_log_variance: torch.Tensor,
    true_mean: torch.Tensor,
    true_log_variance_clipped: torch.Tensor,
    t: Union[int, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example VLB terms in bits; returns ``(vb_losses, decoder_nll)``,
    both ``[B]``. ``t`` is a Python int, a 0-d or a [B] tensor."""
    model_log_variance = torch.broadcast_to(model_log_variance, model_mean.shape)
    kl = mean_flattened(normal_kl(true_mean, true_log_variance_clipped, model_mean, model_log_variance)) / LOG2
    decoder_nll = -discretized_gaussian_log_likelihood(
        samples, means=model_mean, log_scales=0.5 * model_log_variance
    )
    decoder_nll = mean_flattened(decoder_nll) / LOG2
    if not torch.is_tensor(t):
        return (decoder_nll if int(t) == 0 else kl), decoder_nll
    return torch.where(t.to(kl.device) == 0, decoder_nll, kl), decoder_nll


@register_target("diffusion_model_nemo.loss.VariationalBoundLoss")
class VariationalBoundLoss:
    def __init__(self, weight: float = 0.001, detach_model_mean: bool = True, reduction: str = "mean"):
        self.loss_weight = weight
        self.detach_model_mean = detach_model_mean
        self.reduction = reduction

    compute_variation_loss_terms = staticmethod(compute_variational_loss_terms)

    def __call__(self, samples, model_mean, model_log_variance, true_mean,
                 true_log_variance_clipped, t) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.detach_model_mean:
            model_mean = model_mean.detach()
        vb_losses, decoder_nll = compute_variational_loss_terms(
            samples=samples,
            model_mean=model_mean,
            model_log_variance=model_log_variance,
            true_mean=true_mean,
            true_log_variance_clipped=true_log_variance_clipped,
            t=t,
        )
        vb_losses = self.loss_weight * vb_losses
        if self.reduction in ("mean", "batch_mean"):
            return vb_losses.mean(), decoder_nll.mean()
        if self.reduction == "sum":
            return vb_losses.sum(), decoder_nll.sum()
        return vb_losses, decoder_nll
