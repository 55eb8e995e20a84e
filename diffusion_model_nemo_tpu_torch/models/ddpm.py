"""DDPM model: network + sampler + loss from the config, the training step
and sampling.

Counterpart of ``diffusion_model_nemo_tpu/models/ddpm.py`` (``training_step``,
``sample``). The JAX step splits one key into the flip, t, noise and dropout
draws; here ``draw_training_inputs`` draws them from a ``torch.Generator``
and ``training_step`` takes them as tensors, so a test can feed both
packages the same draws (the two RNG streams differ). The training options
are the JAX package's: ``offset_noise_strength: s`` adds s times an injected
per-(example, channel) draw ``offset`` [B, 1, 1, C] to the noise (s = 0: the
base draw, bit for bit); ``snr_gamma: γ`` weights each example's mean loss
by the sampler's Min-SNR-γ weight before the batch mean; a ``pred_v``
sampler regresses v; the network's dropout takes each site's injected keep
mask (``dropout/<site>`` draws). ``test_step`` /
``test_epoch_end`` aggregate dataset-level bits/dim. The sampling
services: ``sample`` (``return_frames``: the trajectory), ``interpolate``
(the sampler's: a q-space lerp and the ancestral chain's last t steps, or
the DDIM chain from a given latent), ``edit`` (SDEdit: the ancestral
partial chain, whatever sampler is configured) and ``inpaint`` (RePaint),
each a captured loop on CUDA.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import instantiate, register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import GaussianDiffusion, _randn
from ..modules.repaint import repaint_loop
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
        if self.loss is None:
            raise ValueError("DDPM training needs a `loss` config")

    def _offset_noise_strength(self) -> float:
        return float(self.cfg.get("offset_noise_strength", 0.0) or 0.0)

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for a batch of images of ``shape`` [B, H, W, C]:
        the horizontal-flip mask (p = 0.5), t ~ U[0, T) (int32), the noise,
        the offset [B, 1, 1, C] under ``offset_noise_strength``, and the
        keep mask of each dropout site (``dropout/<site>``)."""
        B = shape[0]
        dev = self.device
        draws = {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "t": torch.randint(0, self.timesteps, (B,), generator=generator, device=dev, dtype=torch.int32),
            "noise": torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32),
        }
        if self._offset_noise_strength():
            offset = (B,) + (1,) * (len(shape) - 2) + (shape[-1],)
            draws["offset"] = torch.randn(offset, generator=generator, device=dev, dtype=torch.float32)
        draws.update(self.draw_dropout_masks(shape, generator))
        return draws

    def training_noise(self, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step's noise: the base draw, plus s·offset under
        ``offset_noise_strength: s`` (JAX ``_draw_noise``)."""
        strength = self._offset_noise_strength()
        return draws["noise"] + strength * draws["offset"] if strength else draws["noise"]

    def training_target(self, x0, t, noise) -> torch.Tensor:
        """What the network regresses: the true noise (the reference's
        target for pred_noise and pred_x0 alike), or v under ``pred_v``."""
        if getattr(self.sampler, "objective", "pred_noise") == "pred_v":
            return self.sampler.v_target(x0, t, noise)
        return noise

    def _simple_loss(self, model_output, target, t) -> torch.Tensor:
        """L_simple; under ``snr_gamma: γ`` each example's mean loss times
        its Min-SNR-γ weight, then the batch mean, whatever the loss's
        reduction (JAX ``_simple_loss``)."""
        gamma = self.cfg.get("snr_gamma")
        if not gamma:
            return self.loss(input=model_output, target=target)
        per = self.loss.elementwise(model_output, target)
        per = per.reshape(per.shape[0], -1).mean(-1)
        return (self.sampler.min_snr_weight(t, float(gamma)) * per).mean()

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Algorithm 1 of DDPM on a raw uint8 batch with the step's draws:
        preprocess (with the flip), then ``training_loss`` with the training
        network (``get_model_fn``: the dropout masks bound, and a conditional
        model's labels)."""
        self._check_training_options()
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        model_fn = self.get_model_fn(proc, training=True, label_mask=draws.get("label_mask"),
                                     dropout_masks=self.dropout_masks(draws))
        return self.training_loss(params, proc["pixel_values"], draws["t"], self.training_noise(draws), model_fn)

    def training_loss(self, params, x0, t, noise, model_fn=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """q_sample → network (``model_fn``, default ``train_model_fn``) →
        the simple loss against ``training_target``."""
        model_fn = model_fn or self.train_model_fn
        x_t = self.sampler.q_sample(x_start=x0, t=t, noise=noise)
        loss = self._simple_loss(model_fn(params, x_t, t), self.training_target(x0, t, noise), t)
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
        return_frames: bool = False,
    ):
        """Run the sampler's reverse chain; returns [B, H, W, C] in [0, 1]
        (up to the sampler's final step) on the model's device, and with
        ``return_frames`` the trajectory [M, B, H, W, C] too, as ``(out,
        frames)``. ``graphs``: replay captured steps (default: on CUDA) or
        run the Python loop."""
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(self.get_model_fn(), params, shape, generator, graphs=graphs,
                                              return_frames=return_frames)

    def _ancestral_sampler(self, what: str) -> GaussianDiffusion:
        if not isinstance(self.sampler, GaussianDiffusion):
            raise ValueError(f"{what} requires a GaussianDiffusion-family sampler (got "
                             f"{type(self.sampler).__name__})")
        return self.sampler

    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None, lambd: float = 0.5,
                    generator: Optional[torch.Generator] = None, graphs: Optional[bool] = None,
                    return_frames: bool = False, model_fn=None):
        """The sampler's ``interpolate`` of two batches in [-1, 1] with the
        model's weights (not the EMA's, as in the JAX package): the
        ancestral one lerps the endpoints noised to ``t`` and re-denoises,
        DDIM's runs its chain from the latent ``x1``. Returns [B, H, W, C]
        in [0, 1]."""
        if x1.ndim != 4 or x2.ndim != 4:
            raise ValueError(f"x1 and x2 must be batches of images, got {list(x1.shape)} and {list(x2.shape)}")
        with torch.inference_mode():
            return self.sampler.interpolate(model_fn or self.get_model_fn(), self.params, x1.to(self.device),
                                            x2.to(self.device), generator, t=t, lambd=lambd,
                                            return_frames=return_frames, graphs=graphs)

    def edit(self, images: torch.Tensor, strength: float = 0.5, generator: Optional[torch.Generator] = None,
             use_ema: bool = False, graphs: Optional[bool] = None) -> torch.Tensor:
        """SDEdit (Meng et al. 2022): noise ``images`` ([B, H, W, C] in [0,
        1]) to t0 = round(strength·(T − 1)) with one draw from
        ``generator``, then run the last t0 steps of the ancestral chain
        (the base class's, even on a DDIM-configured sampler, as in the
        JAX package). Returns [B, H, W, C] in [0, 1]; each strength is a
        captured chain of its own on CUDA."""
        sampler = self._ancestral_sampler("edit")
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError(f"strength must be in [0, 1], got {strength}")
        if images.ndim != 4:
            raise ValueError(f"images must be a batch [B, H, W, C], got {list(images.shape)}")
        shape = tuple(images.shape)
        t0 = int(round(float(strength) * (self.timesteps - 1)))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            x0 = images.to(device=self.device, dtype=torch.float32) * 2.0 - 1.0
            t_b = torch.full((shape[0],), t0, dtype=torch.int32, device=self.device)
            x_t0 = sampler.q_sample(x0, t_b, _randn(shape, generator, self.device))
            return GaussianDiffusion.p_sample_loop(sampler, self.get_model_fn(), params, shape, generator,
                                                   img=x_t0, num_steps=t0, graphs=graphs)

    def inpaint(self, known: torch.Tensor, mask: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_ema: bool = False, jump_length: int = 10, jump_n_sample: int = 10,
                graphs: Optional[bool] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """RePaint (Lugmayr et al. 2022): fill the ``mask == 0`` region of
        ``known`` ([B, H, W, C] in [0, 1]; ``mask`` broadcast to it, 1 =
        keep) with the model's process (``modules/repaint.py``); NFE ≈ T ·
        jump_n_sample. Returns [B, H, W, C] in [0, 1]; the known region is
        the input's."""
        sampler = self._ancestral_sampler("inpaint")
        if known.ndim != 4:
            raise ValueError(f"known must be a batch [B, H, W, C], got {list(known.shape)}")
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            known = known.to(device=self.device, dtype=torch.float32)
            return repaint_loop(sampler, self.get_model_fn(), params, known * 2.0 - 1.0, mask.to(self.device),
                                generator, jump_length=jump_length, jump_n_sample=jump_n_sample, graphs=graphs,
                                noise=noise)
