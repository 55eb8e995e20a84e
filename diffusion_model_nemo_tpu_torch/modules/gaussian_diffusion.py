"""DDPM process: forward noising, posterior, ancestral sampling.

Counterpart of ``diffusion_model_nemo_tpu/modules/gaussian_diffusion.py``:
the same constant table and formulas (``pred_noise`` / ``pred_x0`` /
``pred_v``, x̂₀ clamped to [-1, 1], zero noise at t = 0). The JAX package's
reverse chain is one ``lax.scan`` over a flat [B, H·W·C] carry; here it is a
Python loop over image-shaped tensors, each step enqueued on the device
without a host sync.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops.schedules import extract
from .diffusion_process import AbstractDiffusionProcess, ModelFn

__all__ = ["GaussianDiffusion", "PMeanVariance", "batched_t"]


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: Optional[torch.Tensor]
    log_variance: torch.Tensor
    pred_x_start: torch.Tensor


def batched_t(t, x: torch.Tensor) -> torch.Tensor:
    """The network's time input is an int32 [B]; the process math takes a
    Python int (the sampling loops), a 0-d tensor (broadcast on its device,
    no host sync) or a [B] tensor."""
    if torch.is_tensor(t):
        return t if t.ndim > 0 else t.to(device=x.device, dtype=torch.int32).expand(x.shape[0])
    return torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@register_target("diffusion_model_nemo.modules.GaussianDiffusion")
class GaussianDiffusion(AbstractDiffusionProcess):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        class_conditional: bool = False,
        zero_terminal_snr: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(timesteps, schedule_name, schedule_cfg, device)
        if objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"objective must be pred_noise|pred_x0|pred_v, got {objective}")
        if class_conditional:
            raise NotImplementedError("class-conditional sampling is not ported yet (ROADMAP.md)")
        if zero_terminal_snr:
            raise NotImplementedError("zero_terminal_snr is not ported yet (ROADMAP.md)")
        self.objective = objective
        self.compute_constants(timesteps)

    # ---- q space -------------------------------------------------------------
    def q_posterior(self, x_start, x, t):
        c = self.constants
        mean = extract(c.posterior_mean_coef1, t, x.ndim) * x_start + extract(
            c.posterior_mean_coef2, t, x.ndim
        ) * x
        return mean, extract(c.posterior_log_variance_clipped, t, x.ndim)

    def q_sample(self, x_start, t, noise):
        """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε; ``noise`` is the caller's."""
        c = self.constants
        return (
            extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
        )

    def predict_start_from_noise(self, x_t, t, noise):
        c = self.constants
        return (
            extract(c.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    def predict_start_from_v(self, x_t, t, v):
        c = self.constants
        return (
            extract(c.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
        )

    # ---- p space -------------------------------------------------------------
    def p_mean_variance(
        self, model_fn: Optional[ModelFn], params: Any, x, t, model_output=None
    ) -> PMeanVariance:
        """Reverse-step Gaussian with the clipped posterior log-variance."""
        if model_output is None:
            model_output = model_fn(params, x, batched_t(t, x))
        if self.objective == "pred_noise":
            x_recon = self.predict_start_from_noise(x, t, model_output)
        elif self.objective == "pred_v":
            x_recon = self.predict_start_from_v(x, t, model_output)
        else:
            x_recon = model_output
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_variance = self.q_posterior(x_recon, x, t)
        return PMeanVariance(mean, None, log_variance, x_recon)

    def p_sample(self, model_fn, params, x, t, generator=None, noise=None):
        """One ancestral step; no noise where t = 0. ``t`` is a Python int
        (the sampling loops: no tensor, no host sync, no draw at t = 0) or a
        0-d or [B] tensor, masked per sample as the JAX package does.
        ``noise`` may be injected (tests feed both packages the same draws)."""
        out = self.p_mean_variance(model_fn, params, x, t)
        if not torch.is_tensor(t) and int(t) == 0:
            return out.mean
        if noise is None:
            noise = _randn(x.shape, generator, x.device)
        step = torch.exp(0.5 * out.log_variance) * noise
        if torch.is_tensor(t):
            mask = (t.to(x.device) != 0).to(step.dtype)
            step = step * (mask.reshape(-1, *((1,) * (x.ndim - 1))) if t.ndim else mask)
        return out.mean + step

    def p_sample_loop(
        self,
        model_fn: ModelFn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        img: Optional[torch.Tensor] = None,
        num_steps: Optional[int] = None,
        unnormalize: bool = True,
    ) -> torch.Tensor:
        """Reverse chain over t = T−1 … 0 (or the last ``num_steps`` steps)
        from ``img`` (default N(0, I) from ``generator``)."""
        T = self.timesteps if num_steps is None else int(num_steps)
        x = img if img is not None else _randn(shape, generator, self.device)
        for t in np.arange(T - 1, -1, -1):
            x = self.p_sample(model_fn, params, x, int(t), generator)
        return (x + 1.0) * 0.5 if unnormalize else x

    def sample(self, model_fn, params, shape, generator=None, **kwargs):
        return self.p_sample_loop(model_fn, params, shape, generator, **kwargs)
