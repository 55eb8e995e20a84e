"""Numerics shared by the variational bound and bits/dim.

Counterpart of ``diffusion_model_nemo_tpu/ops/math.py`` (the reference's
``diffusion_model_nemo/utils.py:10-65``): the same formulas on tensors.
"""

from __future__ import annotations

import math
from typing import List

import torch

__all__ = [
    "log",
    "mean_flattened",
    "sum_flattened",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "num_to_groups",
    "LOG2",
]

LOG2 = math.log(2.0)


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=like.dtype, device=like.device)


def log(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Log with the input clamped at ``eps``."""
    return torch.log(t.clamp(min=eps))


def mean_flattened(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes → ``[B]``."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def sum_flattened(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes → ``[B]``."""
    return x.sum(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) ‖ N(mean2, e^logvar2)), elementwise; any
    argument may be a Python float."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2) if torch.is_tensor(a))
    mean1, logvar1, mean2, logvar2 = (_t(a, like) for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x**3))))


def discretized_gaussian_log_likelihood(
    x: torch.Tensor, *, means: torch.Tensor, log_scales: torch.Tensor, thres: float = 0.999
) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 8-bit bins of width 2/255,
    elementwise, for images in [-1, 1], with the tail bins at |x| > thres."""
    if not (x.shape == means.shape == log_scales.shape):
        raise ValueError(f"shapes differ: {x.shape}, {means.shape}, {log_scales.shape}")
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = log(cdf_plus)
    log_one_minus_cdf_min = log(1.0 - cdf_min)
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -thres, log_cdf_plus, torch.where(x > thres, log_one_minus_cdf_min, log(cdf_delta))
    )


def num_to_groups(num: int, divisor: int) -> List[int]:
    """Split ``num`` into chunks of at most ``divisor``."""
    groups, remainder = divmod(num, divisor)
    return [divisor] * groups + ([remainder] if remainder > 0 else [])
