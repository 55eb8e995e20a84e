"""Improved DDPM (Nichol & Dhariwal): the hybrid L_simple + VLB loss with a
learned variance.

Counterpart of ``diffusion_model_nemo_tpu/models/improved_ddpm.py``: the
network's output is split on the channel axis into (ε̂, v); the simple loss
takes the ε̂ half against the noise; the VLB term takes ``q_posterior`` and
the sampler's ``p_mean_variance(model_output=...)`` (a
``LearnedGaussianDiffusion``) through ``vb_loss``, whose
``detach_model_mean`` stops the mean's gradient, so that only the variance
half learns from it. The total is simple + vb. The draws (flip, t, noise,
offset, dropout masks) and the training options are DDPM's: under
``pred_v`` the first half is a v-prediction regressed on v, and Min-SNR-γ
weights the simple term only. Bits/dim reads the learned variance through
the sampler.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config.registry import instantiate, register_target
from .ddpm import DDPM

__all__ = ["ImprovedDDPM"]


@register_target("diffusion_model_nemo.models.ImprovedDDPM")
class ImprovedDDPM(DDPM):
    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.vb_loss = instantiate(self.cfg.get("vb_loss"))

    def _check_training_options(self) -> None:
        super()._check_training_options()
        if self.vb_loss is None:
            raise ValueError("ImprovedDDPM training needs a `vb_loss` config")

    def training_loss(self, params, x0, t, noise, model_fn=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model_fn = model_fn or self.train_model_fn
        x_t = self.sampler.q_sample(x_start=x0, t=t, noise=noise)
        model_output = model_fn(params, x_t, t)
        pred, _ = model_output.chunk(2, dim=-1)
        simple = self._simple_loss(pred, self.training_target(x0, t, noise), t)
        true_mean, true_log_variance_clipped = self.sampler.q_posterior(x_start=x0, x=x_t, t=t)
        out = self.sampler.p_mean_variance(None, params, x=x_t, t=t, model_output=model_output)
        vb, decoder_nll = self.vb_loss(
            samples=x0,
            model_mean=out.mean,
            model_log_variance=out.log_variance,
            true_mean=true_mean,
            true_log_variance_clipped=true_log_variance_clipped,
            t=t,
        )
        total = simple + vb
        return total, {"train_loss": total, "simple_loss": simple, "vb_losses": vb, "decoder_nll": decoder_nll}
