"""Cascaded generation (Ho et al. 2022): a base generator and SR3 upscalers.

Counterpart of ``diffusion_model_nemo_tpu/pipelines/cascade.py``: a base
model whose ``sample`` returns [B, H, W, C] images in [0, 1] (DDPM,
ImprovedDDPM, ConditionalDDPM, EDM, ...) feeds one or more SR3 upscalers,
each super-resolving the previous stage's output. Every stage runs its own
captured chain on CUDA, and the images between stages stay on the device.

Random-stream contract (the JAX package's ``fold_in(key, i)`` per stage,
in torch terms): stage ``i`` (0 the base, ``i >= 1`` the i-th upscaler)
draws from ``stage_generator(seed, i)``, a generator seeded by (seed, i)
alone. So a cascade equals its stages run by hand with those generators,
and adding an upscaler changes no earlier stage.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["CascadePipeline", "stage_generator"]

log = logging.getLogger(__name__)


def stage_generator(seed: int, stage: int, device: Union[str, torch.device]) -> torch.Generator:
    """Stage ``stage``'s generator on ``device``: seeded from (seed, stage)
    through numpy's ``SeedSequence``."""
    state = np.random.SeedSequence([int(seed), int(stage)]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class CascadePipeline:
    """A base generator and a chain of SR3 upscalers, geometry checked.

    Args:
        base: any model with ``sample(batch_size, image_size, generator=...)``
            returning [B, H, W, C] images in [0, 1].
        upscalers: SR3 models, low to high resolution. Each one's LR size
            (``image_size // scale_factor``) must equal the previous stage's
            output size, and the channels must match.
    """

    def __init__(self, base, upscalers: Sequence):
        upscalers = list(upscalers)
        if not upscalers:
            raise ValueError("CascadePipeline needs at least one SR3 upscaler")
        size, channels = int(base.image_size), int(base.channels)
        for i, up in enumerate(upscalers):
            if not (hasattr(up, "super_resolve") and hasattr(up, "scale_factor")):
                raise TypeError(f"upscaler {i} ({type(up).__name__}) is not an SR3-style model (needs "
                                "super_resolve + scale_factor)")
            lr_size = int(up.image_size) // int(up.scale_factor)
            if lr_size != size:
                raise ValueError(f"geometry mismatch at stage {i + 1}: upscaler expects {lr_size}x{lr_size} inputs "
                                 f"(image_size {int(up.image_size)} / scale_factor {int(up.scale_factor)}) but the "
                                 f"previous stage produces {size}x{size}")
            if int(up.channels) != channels:
                raise ValueError(f"channel mismatch at stage {i + 1}: upscaler has {int(up.channels)} channels, "
                                 f"previous stage {channels}")
            size = int(up.image_size)
        self.base = base
        self.upscalers: List = upscalers
        self.final_image_size = size
        self.channels = channels

    @property
    def stages(self) -> List:
        return [self.base] + self.upscalers

    def sample(self, batch_size: int, seed: int = 0, use_ema: bool = False, return_stages: bool = False,
               graphs: Optional[bool] = None, **base_kwargs):
        """The base's sample (``base_kwargs`` go to it: ``label=``,
        ``guidance_scale=`` for a conditional base), then each upscaler's
        ``super_resolve``; stage i draws from ``stage_generator(seed, i)``.
        Returns [B, final, final, C] in [0, 1] on the last stage's device;
        with ``return_stages`` every stage's output, low to high."""
        x = self.base.sample(batch_size, int(self.base.image_size),
                             generator=stage_generator(seed, 0, self.base.device), use_ema=use_ema, graphs=graphs,
                             **base_kwargs)
        outs = [x]
        for i, up in enumerate(self.upscalers):
            x = up.super_resolve(x, generator=stage_generator(seed, i + 1, up.device), use_ema=use_ema,
                                 graphs=graphs)
            outs.append(x)
        return outs if return_stages else x

    @classmethod
    def from_archives(cls, base_path: str, upscaler_paths: Sequence[str], use_ema: bool = False,
                      device: Union[str, torch.device] = "cuda") -> "CascadePipeline":
        """The cascade of ``.dmn`` archives: the base restores as its family
        (``restore_model_from_archive``), each upscaler as SR3."""
        from ..models import SR3, restore_model_from_archive

        base = restore_model_from_archive(base_path, use_ema=use_ema, device=device)
        ups = [SR3.restore_from(p, use_ema=use_ema, device=device) for p in upscaler_paths]
        pipe = cls(base, ups)
        log.info(f"Cascade: {type(base).__name__}@{int(base.image_size)} → "
                 + " → ".join(f"SR3@{int(u.image_size)}(x{int(u.scale_factor)})" for u in ups))
        return pipe
