"""L_simple: l1 / l2 / huber between the model's output and the target noise.

Counterpart of ``diffusion_model_nemo_tpu/loss/simple_loss.py``: reductions
``mean`` / ``sum`` / ``none`` / ``batch_mean`` (per-sample sum, then the
batch mean); huber is torch's ``smooth_l1_loss`` with beta = 1.
"""

from __future__ import annotations

import torch

from ..config.registry import register_target

__all__ = ["DiffusionLoss"]

_LOSS_TYPES = ("l1", "l2", "huber")
_REDUCTIONS = ("mean", "sum", "none", "batch_mean")


@register_target("diffusion_model_nemo.loss.DiffusionLoss")
class DiffusionLoss:
    def __init__(self, loss_type: str, reduction: str = "mean"):
        if loss_type not in _LOSS_TYPES:
            raise ValueError(f"Loss type {loss_type} is not implemented !")
        if reduction not in _REDUCTIONS:
            raise ValueError(f"Invalid reduction {reduction}")
        self.loss_type = loss_type
        self.reduction = reduction

    def elementwise(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "l1":
            return (input - target).abs()
        if self.loss_type == "l2":
            return (input - target) ** 2
        diff = (input - target).abs()
        return torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss = self.elementwise(input, target)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        if self.reduction == "batch_mean":
            return loss.reshape(loss.shape[0], -1).sum(-1).mean()
        return loss
