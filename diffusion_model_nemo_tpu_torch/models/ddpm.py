"""DDPM model: network + sampler + loss from the config, the training step
and sampling.

Counterpart of ``diffusion_model_nemo_tpu/models/ddpm.py`` (``training_step``,
``sample``). The JAX step splits one key into the flip, t and noise draws;
here ``draw_training_inputs`` draws them from a ``torch.Generator`` and
``training_step`` takes them as tensors, so a test can feed both packages
the same draws (the two RNG streams differ). ``test_step`` /
``test_epoch_end`` aggregate dataset-level bits/dim. Min-SNR-γ weighting,
offset noise, ``pred_v`` training, dropout, inpainting, editing and
interpolation are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import instantiate, register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.parts import not_ported
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["DDPM"]

log = logging.getLogger(__name__)


@register_target("diffusion_model_nemo.models.DDPM")
class DDPM(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.diffusion_model = self.build_network()
        self.sampler = instantiate(self.cfg.sampler, device=self.device)
        self.loss = instantiate(self.cfg.get("loss"))
        self.init_params()

    # ---- training ------------------------------------------------------------
    def _check_training_options(self) -> None:
        for key in ("snr_gamma", "offset_noise_strength"):
            if self.cfg.get(key):
                raise not_ported("DDPM", f"{key}={self.cfg.get(key)}", "training extras")
        if getattr(self.sampler, "objective", "pred_noise") == "pred_v":
            raise not_ported("DDPM", "objective='pred_v' training", "training extras")
        if float(self.cfg.diffusion_model.get("dropout") or 0.0) > 0:
            raise not_ported("DDPM", "dropout > 0 in training", "training extras")
        if self.loss is None:
            raise ValueError("DDPM training needs a `loss` config")

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for a batch of images of ``shape`` [B, H, W, C]:
        the horizontal-flip mask (p = 0.5), t ~ U[0, T) (int32) and the noise."""
        B = shape[0]
        dev = self.device
        return {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "t": torch.randint(0, self.timesteps, (B,), generator=generator, device=dev, dtype=torch.int32),
            "noise": torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32),
        }

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Algorithm 1 of DDPM on a raw uint8 batch with the step's draws:
        preprocess (with the flip), then ``training_loss`` with the training
        network (``get_model_fn``: a conditional model binds the labels)."""
        self._check_training_options()
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        model_fn = self.get_model_fn(proc, training=True, label_mask=draws.get("label_mask"))
        return self.training_loss(params, proc["pixel_values"], draws["t"], draws["noise"], model_fn)

    def training_loss(self, params, x0, t, noise, model_fn=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """q_sample → network (``model_fn``, default ``train_model_fn``) →
        loss against the true noise (the reference's target for pred_noise
        and pred_x0 alike)."""
        model_fn = model_fn or self.train_model_fn
        x_t = self.sampler.q_sample(x_start=x0, t=t, noise=noise)
        loss = self.loss(input=model_fn(params, x_t, t), target=noise)
        return loss, {"train_loss": loss}

    # ---- evaluation ----------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Bits/dim of a raw uint8 batch (no flip), summed over the batch
        (a conditional model's network sees the batch's labels)."""
        proc = preprocess_batch(batch, self.device)
        samples = proc["pixel_values"]
        log_dict = self.calculate_bits_per_dimension(
            x_start=samples, generator=generator, max_batch_size=-1, noise=noise,
            model_fn=self.get_model_fn(proc),
        )
        out = {k: v.sum() for k, v in log_dict.items()}
        out["num_samples"] = samples.shape[0]
        return out

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = float(sum(o["num_samples"] for o in outputs))
        result = {
            f"test_{k}": float(sum(float(o[k]) for o in outputs)) / total
            for k in ("total_bpd", "terms_bpd", "prior_bpd")
        }
        log.info(f"Test bits/dim: {result}")
        return result

    # ---- sampling ------------------------------------------------------------
    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        use_ema: bool = False,
        graphs: Optional[bool] = None,
    ) -> torch.Tensor:
        """Run the sampler's reverse chain; returns [B, H, W, C] in [0, 1]
        (up to the sampler's final step) on the model's device. ``graphs``:
        replay captured steps (default: on CUDA) or run the Python loop."""
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(self.get_model_fn(), params, shape, generator, graphs=graphs)
