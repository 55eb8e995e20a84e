"""Improved-DDPM learned-variance process (Nichol & Dhariwal).

Counterpart of
``diffusion_model_nemo_tpu/modules/learned_gaussian_diffusion.py``: the
network's output is split on the last (channel) axis of the NHWC image
into (ε̂, v); v is mapped from [-1, 1] to frac in [0, 1] and interpolates
``log σ² = frac·log β_t + (1 − frac)·log β̃_t`` (β̃_t the clipped posterior
variance). The network's output is float32, so the split, the
interpolation and its ``exp`` are float32. Under ``pred_v`` the first half
is a v-prediction. Sampling, the captured ancestral chain and bits/dim are
``GaussianDiffusion``'s, reading this ``p_mean_variance``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..config.registry import register_target
from ..ops.schedules import extract
from .diffusion_process import ModelFn
from .gaussian_diffusion import GaussianDiffusion, PMeanVariance, batched_t

__all__ = ["LearnedGaussianDiffusion"]


@register_target("diffusion_model_nemo.modules.LearnedGaussianDiffusion")
class LearnedGaussianDiffusion(GaussianDiffusion):
    def model_log_variance(self, model_output: torch.Tensor, x: torch.Tensor, t) -> torch.Tensor:
        """The interpolated log variance from the v half of ``model_output``."""
        _, v = model_output.chunk(2, dim=-1)
        min_log = extract(self.constants.posterior_log_variance_clipped, t, x.ndim)
        max_log = extract(self.constants.log_betas, t, x.ndim)
        frac = (v + 1.0) * 0.5
        return frac * max_log + (1.0 - frac) * min_log

    def p_mean_variance(
        self, model_fn: Optional[ModelFn], params: Any, x, t, model_output=None
    ) -> PMeanVariance:
        if model_output is None:
            model_output = model_fn(params, x, batched_t(t, x))
        pred, _ = model_output.chunk(2, dim=-1)
        log_variance = self.model_log_variance(model_output, x, t)
        if self.objective == "pred_v":
            x_start = self.predict_start_from_v(x, t, pred)
        else:
            x_start = self.predict_start_from_noise(x, t, pred)
        x_start = x_start.clamp(-1.0, 1.0)
        mean, _ = self.q_posterior(x_start, x, t)
        return PMeanVariance(mean, torch.exp(log_variance), log_variance, x_start)
