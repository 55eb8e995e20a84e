"""DDPM model, inference part: network + sampler from the config, sampling.

Counterpart of ``diffusion_model_nemo_tpu/models/ddpm.py`` (``sample``).
Training, bits/dim, inpainting, editing and interpolation are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config.registry import instantiate, register_target
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["DDPM"]


@register_target("diffusion_model_nemo.models.DDPM")
class DDPM(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.diffusion_model = self.build_network()
        self.sampler = instantiate(self.cfg.sampler, device=self.device)
        self.init_params()

    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        use_ema: bool = False,
    ) -> torch.Tensor:
        """Run the sampler's reverse chain; returns [B, H, W, C] in [0, 1]
        (up to the sampler's final step) on the model's device."""
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(self.get_model_fn(), params, shape, generator)
