"""WaveGrad-style DDPM: continuous-noise-level training on the FiLM U-Net,
and sample dumps on a searched short schedule.

Counterpart of ``diffusion_model_nemo_tpu/models/wavegrad_ddpm.py``. The
JAX step splits one key into the flip, the level and the noise draws; here
``draw_training_inputs`` draws them (the flip, the level's index ``s`` in
[1, T] and fraction ``u``, the noise) and ``training_step`` takes them as
tensors, so a test can feed both packages the same draws. The sample dump
searches a 50-step schedule (100 candidates, seed 0), samples on it and
restores the training schedule before anything else reads the table
(bits/dim under ``compute_bpd`` runs on the restored 1000-step table).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config.registry import register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.wavegrad_diffusion import WaveGradDiffusion
from .ddpm import DDPM

__all__ = ["WavegradDDPM", "DUMP_TIMESTEPS", "DUMP_SEARCH_ITERS"]

DUMP_TIMESTEPS, DUMP_SEARCH_ITERS = 50, 100  # the sample dump's short schedule and its search


@register_target("diffusion_model_nemo.models.WavegradDDPM")
class WavegradDDPM(DDPM):
    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        assert isinstance(self.sampler, WaveGradDiffusion), "This class must implement WaveGradDiffusion as its sampler"

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, H, W, C]: the flip
        mask (p = 0.5), the level's schedule index s ~ U{1 … T} (int32) and
        fraction u ~ U[0, 1), and the noise."""
        B, dev = shape[0], self.device
        return {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "s": torch.randint(1, self.sampler.timesteps + 1, (B,), generator=generator, device=dev,
                               dtype=torch.int32),
            "u": torch.rand((B,), generator=generator, device=dev),
            "noise": torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32),
        }

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss at a continuous level: x_t = level·x₀ + √(1 − level²)·ε,
        the network conditioned on the level (the JAX step calls the network
        without labels, so a ``num_classes`` network sees the null class)."""
        self._check_training_options()
        x0 = preprocess_batch(batch, self.device, flip=draws["flip"])["pixel_values"]
        level = self.sampler.sample_continuous_noise_level(draws["s"], draws["u"])
        x_t = self.sampler.q_sample_continuous(x0, level, draws["noise"])
        loss = self.loss(input=self.train_model_fn(params, x_t, level), target=draws["noise"])
        return loss, {"train_loss": loss}

    def _save_image_step(self, batch_size: int, step: int):
        """The dump's grid on the searched 50-step schedule, then the
        original schedule back."""
        self.sampler.use_searched_schedule(DUMP_TIMESTEPS, DUMP_SEARCH_ITERS, seed=0)
        try:
            return super()._save_image_step(batch_size, step)
        finally:
            self.sampler.restore_schedule()

    def interpolate(self, *args, **kwargs):
        raise NotImplementedError()
