"""SR3 super-resolution diffusion (Saharia et al. 2021).

Counterpart of ``diffusion_model_nemo_tpu/models/sr3.py``: the denoiser is
conditioned on the upsampled low-resolution image by channel concatenation
([x_t, up(LR)], 2C input channels, C out), and trained with the DDPM
objective on (LR, HR) pairs made inside the step from the training images
(``degrade``: an antialiased shrink by ``scale_factor``, then ``upsample``
back, both ``ops/resize.py``'s copy of ``jax.image.resize`` with
``lowres_method``), so any image dataset is an SR dataset.

The condition reaches every sampler as a :class:`Conditioned` model
function (``modules/gaussian_diffusion.py``): a captured chain (ancestral,
or DDIM / DPM-Solver++ after a sampler swap) and the bits/dim loop hold it
as a static buffer that every call refills, so one graph serves every LR
batch. Training binds it, and the dropout masks, into the step's network;
``cond_aug_std`` adds s times an injected normal draw (``cond_aug``, drawn
with the step's other draws) to the training condition only (Ho et al.
2022's conditioning augmentation; the JAX step draws it from
``fold_in(dropout key, 0x5347)``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Union

import torch

from ..config.registry import register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import Conditioned
from ..ops.resize import resize
from .ddpm import DDPM

__all__ = ["SR3"]

_RESIZE_METHODS = ("bilinear", "bicubic", "lanczos3", "nearest")


@register_target("diffusion_model_nemo.models.SR3", "diffusion_model_nemo_tpu.models.SR3")
class SR3(DDPM):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.scale_factor = int(self.cfg.get("scale_factor", 4))
        if self.scale_factor < 2:
            raise ValueError(f"scale_factor must be >= 2, got {self.scale_factor}")
        if int(self.image_size) % self.scale_factor:
            raise ValueError(f"image_size {self.image_size} not divisible by scale_factor {self.scale_factor}")
        self.lowres_method = str(self.cfg.get("lowres_method", "bicubic"))
        if self.lowres_method not in _RESIZE_METHODS:
            raise ValueError(f"lowres_method must be one of {_RESIZE_METHODS}, got {self.lowres_method}")
        self.cond_aug_std = float(self.cfg.get("cond_aug_std", 0.0))
        if self.cond_aug_std < 0:
            raise ValueError(f"cond_aug_std must be >= 0, got {self.cond_aug_std}")
        self._vis_batch: Optional[torch.Tensor] = None  # the sample dumps' LR batch

    def _example_input_channels(self) -> int:
        return 2 * int(self.channels)  # [x_t, upsampled LR]

    # ---- conditioning -----------------------------------------------------------
    def degrade(self, samples: torch.Tensor) -> torch.Tensor:
        """HR [-1, 1] → LR [-1, 1] (an antialiased shrink: the training-time
        degradation, SR3 §2)."""
        B, H, W, C = samples.shape
        s = self.scale_factor
        return resize(samples, (B, H // s, W // s, C), self.lowres_method, antialias=True)

    def upsample(self, lr: torch.Tensor) -> torch.Tensor:
        """LR [-1, 1] → the condition at HR resolution."""
        B, h, w, C = lr.shape
        s = self.scale_factor
        return resize(lr, (B, h * s, w * s, C), self.lowres_method, antialias=False)

    def _lowres_condition(self, samples: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.degrade(samples))

    @staticmethod
    def _concat(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, cond.to(x.dtype).expand(x.shape)], dim=-1)

    def conditioned_forward(self, params, x, t, cond):
        """The network on [x, cond] (inference)."""
        return self.model_fn(params, self._concat(x, cond), t)

    def _train_forward(self, params, x, t, cond, dropout_masks=None):
        return self.train_model_fn(params, self._concat(x, cond), t, dropout_masks=dropout_masks)

    @staticmethod
    def _unbound(params, x, t):
        raise ValueError("SR3 needs low-res conditioning: pass a batch or cond= to get_model_fn "
                         "(use super_resolve for inference)")

    def get_model_fn(self, batch: Optional[Dict] = None, training: bool = False,
                     dropout_masks: Optional[Dict[str, torch.Tensor]] = None, cond: Optional[torch.Tensor] = None,
                     cond_noise: Optional[torch.Tensor] = None):
        """The network with the condition bound: ``cond`` (at HR resolution,
        [-1, 1]) or derived from ``batch``'s HR images (down → up; in
        training plus ``cond_aug_std`` times ``cond_noise``). Inference
        binds it as a :class:`Conditioned` (a graph's static buffer),
        training with the dropout masks. Without a condition the function
        raises when called."""
        if cond is None and batch is not None:
            cond = self._lowres_condition(batch["pixel_values"])
            if training and self.cond_aug_std > 0 and cond_noise is not None:
                cond = cond + self.cond_aug_std * cond_noise
        if cond is None:
            return self._unbound
        if training:
            return functools.partial(self._train_forward, cond=cond, dropout_masks=dropout_masks or None)
        return Conditioned(self.conditioned_forward, {"cond": cond})

    # ---- training ---------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """DDPM's draws, and under ``cond_aug_std`` the condition's noise
        ``cond_aug`` [B, H, W, C]."""
        draws = super().draw_training_inputs(shape, generator)
        if self.cond_aug_std > 0:
            draws["cond_aug"] = torch.randn(tuple(shape), generator=generator, device=self.device,
                                            dtype=torch.float32)
        return draws

    def training_step(self, params, batch, draws):
        """DDPM's step with the condition derived from the flipped batch
        (and ``cond_aug`` added) bound into the network."""
        self._check_training_options()
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        model_fn = self.get_model_fn(proc, training=True, dropout_masks=self.dropout_masks(draws),
                                     cond_noise=draws.get("cond_aug"))
        return self.training_loss(params, proc["pixel_values"], draws["t"], self.training_noise(draws), model_fn)

    # ---- inference --------------------------------------------------------------
    def super_resolve(self, lr, generator: Optional[torch.Generator] = None, use_ema: bool = False,
                      return_frames: bool = False, data_space: bool = False, graphs: Optional[bool] = None):
        """Iterative refinement: LR [B, h, w, C] in [0, 1] (``data_space``:
        [-1, 1]) → [B, h·s, w·s, C] in [0, 1] on the model's device, through
        the sampler's chain (captured on CUDA: every LR batch replays one
        graph, its condition a static buffer). ``return_frames`` as in
        ``DDPM.sample``."""
        lr = torch.as_tensor(lr)
        if lr.ndim != 4:
            raise ValueError(f"lr is not a batch of images: {list(lr.shape)}")
        B, h, w, _C = lr.shape
        s = self.scale_factor
        shape = (B, h * s, w * s, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            lr = lr.to(device=self.device, dtype=torch.float32)
            if not data_space:
                lr = lr * 2.0 - 1.0
            model_fn = Conditioned(self.conditioned_forward, {"cond": self.upsample(lr)})
            return self.sampler.p_sample_loop(model_fn, params, shape, generator, graphs=graphs,
                                              return_frames=return_frames)

    def sample(self, batch_size: int, image_size: int, generator: Optional[torch.Generator] = None,
               use_ema: bool = False, graphs: Optional[bool] = None, return_frames: bool = False, lr=None):
        """``super_resolve(lr)``; without ``lr`` the LRs of the first batch
        of the attached dataloader (the sample dumps' path), else it
        raises."""
        kwargs = dict(generator=generator, use_ema=use_ema, graphs=graphs, return_frames=return_frames)
        if lr is None:
            lr = self._dataset_lr(batch_size)
            if lr is None:
                raise ValueError("SR3.sample needs lr= (no dataloader attached to derive a visualization "
                                 "batch from); use super_resolve(lr)")
            return self.super_resolve(lr, data_space=True, **kwargs)
        return self.super_resolve(lr, **kwargs)

    def _dataset_lr(self, batch_size: int) -> Optional[torch.Tensor]:
        """The degraded first batch of the train (else test) loader, [-1, 1],
        kept for later dumps; its first ``batch_size`` rows."""
        if self._vis_batch is None:
            dl = self._train_dl or self._test_dl
            if dl is None:
                return None
            proc = preprocess_batch(next(iter(dl)), self.device)
            with torch.inference_mode():
                self._vis_batch = self.degrade(proc["pixel_values"])
        return self._vis_batch[: min(batch_size, self._vis_batch.shape[0])]

    def interpolate(self, *args, **kwargs):
        raise NotImplementedError("SR3 is conditioned on a low-res image; interpolate is undefined "
                                  "(super-resolve two LRs and blend in LR space instead)")

    # ---- evaluation --------------------------------------------------------------
    def calculate_bits_per_dimension(self, x_start: torch.Tensor, generator: Optional[torch.Generator] = None,
                                     max_batch_size: int = 32, noise: Optional[torch.Tensor] = None,
                                     graphs: Optional[bool] = None, model_fn=None) -> Dict[str, torch.Tensor]:
        """Bits/dim of p(HR | LR), the LR derived from ``x_start`` (down → up)
        when no bound ``model_fn`` is given (the Trainer's ``compute_bpd``
        dump); the test step binds its batch's."""
        if model_fn is None:
            if max_batch_size > 0:
                x_start = x_start[: min(max_batch_size, x_start.shape[0])]
            with torch.inference_mode():
                model_fn = Conditioned(self.conditioned_forward, {"cond": self._lowres_condition(x_start)})
            max_batch_size = -1
        return super().calculate_bits_per_dimension(x_start, generator=generator, max_batch_size=max_batch_size,
                                                    noise=noise, graphs=graphs, model_fn=model_fn)

    @staticmethod
    def psnr(sr, hr, max_val: float = 1.0) -> torch.Tensor:
        """PSNR [B] in dB of images in [0, 1] (SR3 Table 1's metric)."""
        sr = torch.as_tensor(sr).float()
        hr = torch.as_tensor(hr).float().to(sr.device)
        mse = ((sr - hr) ** 2).mean(dim=(1, 2, 3))
        return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))
