"""Beta schedules and the precomputed diffusion constant table (PyTorch).

Counterpart of ``diffusion_model_nemo_tpu/ops/schedules.py``. The schedules
and every derived constant are computed on the host in float64 with numpy
and stored as float32 tensors on the caller's device, exactly as the JAX
package stores them, so both packages sample from bit-identical tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = [
    "SCHEDULE_NAMES",
    "cosine_beta_schedule",
    "linear_beta_schedule",
    "quadratic_beta_schedule",
    "sigmoid_beta_schedule",
    "get_named_beta_schedule",
    "ScheduleConstants",
    "compute_schedule_constants",
    "extract",
]

SCHEDULE_NAMES = ("linear", "quadratic", "sigmoid", "cosine")


def cosine_beta_schedule(
    timesteps: int, s: float = 0.008, min_clip: float = 0.0001, max_clip: float = 0.999
) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal), float64 on the host → float32."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, min_clip, max_clip).astype(np.float32)


def linear_beta_schedule(
    timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02
) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64).astype(np.float32)


def quadratic_beta_schedule(
    timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02
) -> np.ndarray:
    return (
        np.linspace(beta_start**0.5, beta_end**0.5, timesteps, dtype=np.float64) ** 2
    ).astype(np.float32)


def sigmoid_beta_schedule(
    timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02
) -> np.ndarray:
    x = np.linspace(-6, 6, timesteps, dtype=np.float64)
    betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    return betas.astype(np.float32)


_SCHEDULE_FNS = {
    "cosine": cosine_beta_schedule,
    "linear": linear_beta_schedule,
    "quadratic": quadratic_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def get_named_beta_schedule(
    schedule_name: str, timesteps: int, schedule_cfg: Optional[Dict[str, Any]] = None
) -> np.ndarray:
    """Resolve a schedule by name. ``schedule_cfg`` is either the YAML layout
    keyed by schedule name (``{"cosine": {...}, "linear": {...}}``) or a flat
    kwargs dict for the named schedule."""
    if schedule_name not in _SCHEDULE_FNS:
        raise ValueError(
            f"Invalid schedule `{schedule_name}`; must be one of {sorted(_SCHEDULE_FNS)}"
        )
    kwargs: Dict[str, Any] = {}
    if schedule_cfg:
        if schedule_name in schedule_cfg and isinstance(schedule_cfg[schedule_name], dict):
            kwargs = dict(schedule_cfg[schedule_name])
        elif not any(k in _SCHEDULE_FNS for k in schedule_cfg):
            kwargs = dict(schedule_cfg)
    return _SCHEDULE_FNS[schedule_name](timesteps=timesteps, **kwargs)


@dataclass(frozen=True)
class ScheduleConstants:
    """Per-timestep diffusion constants, each a float32 ``[T]`` tensor
    (``sqrt_alphas_cumprod_prev`` is ``[T + 1]`` with a leading 1.0)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    log_betas: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod_m1: torch.Tensor


def compute_schedule_constants(
    timesteps: int,
    schedule_name: str,
    schedule_cfg: Optional[Dict[str, Any]] = None,
    device: Union[str, torch.device] = "cuda",
) -> ScheduleConstants:
    """Build the full constant table in float64 on the host and store it as
    float32 tensors on ``device``."""
    betas = get_named_beta_schedule(schedule_name, timesteps, schedule_cfg).astype(np.float64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # Variance is 0 at t=0; the log reuses the t=1 value.
    posterior_log_variance_clipped = np.log(
        np.concatenate([[posterior_variance[1]], posterior_variance[1:]])
    )
    sqrt_acp_prev_with_last = np.sqrt(np.concatenate([[1.0], alphas_cumprod]))

    def f32(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)

    with np.errstate(divide="ignore"):
        return ScheduleConstants(
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_recip_alphas=f32(np.sqrt(1.0 / alphas)),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            log_betas=f32(np.log(betas)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            sqrt_alphas_cumprod_prev=f32(sqrt_acp_prev_with_last),
            sqrt_alphas_cumprod_m1=f32(
                np.sqrt(1.0 - alphas_cumprod) * np.sqrt(1.0 / alphas_cumprod)
            ),
        )


def extract(table: torch.Tensor, t: Union[int, torch.Tensor], ndim: int) -> torch.Tensor:
    """Gather per-example constants and shape them to broadcast over ``ndim``
    dims: a scalar ``t`` (a Python int in the sampling loops, or a 0-d
    tensor, gathered on its device without a host sync) gives ``[1, ..., 1]``,
    a ``[B]`` ``t`` (training, bits/dim) gives ``[B, 1, ..., 1]``."""
    if not torch.is_tensor(t):
        return table[int(t)].reshape((1,) * ndim)
    out = table.gather(0, t.reshape(-1).to(device=table.device, dtype=torch.long))
    return out.reshape(out.shape[0] if t.ndim else 1, *((1,) * (ndim - 1)))
