"""EDM model (Karras et al. 2022, trained in its own parameterization):
network + ``EDMProcess`` + ``EDMLoss`` from the config, the training step,
evaluation, bits/dim and the sampling services.

Counterpart of ``diffusion_model_nemo_tpu/models/edm.py``. The JAX step
splits one key into the flip, σ, noise and dropout draws (and folds one in
for the augmentation); here ``draw_training_inputs`` draws them from a
``torch.Generator`` and ``training_step`` takes them as tensors: ``flip``
[B], ``sigma_z`` [B] (ln σ = P_mean + P_std·z), ``noise``, the dropout
masks, and under ``augment_prob > 0`` the augmentation descriptor
``augment`` [B, 9] (``data/augment.py``), which the step applies to the
batch and feeds to the network (``aug_cond``); all device tensor math, so
the whole step is one captured graph on CUDA. Sampling conditions on the
zero descriptor. As in the JAX package, ``augment_prob > 0`` without a
network ``aug_dim`` and a ``loss.sigma_data`` other than the sampler's are
refused at construction.

``test_step`` reports the λ-weighted denoising loss (``test_edm_loss``) and,
under ``compute_nll``, the probability-flow bits/dim and its NFE
(``test_total_bpd``); ``calculate_bits_per_dimension`` (the Trainer's
``compute_bpd`` dump) is that NLL, with the model's own weights only, as in
the JAX package. ``sample`` (``num_steps``, ``return_frames``, churn from
the sampler), ``encode`` and ``interpolate`` run captured loops on CUDA.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import instantiate, register_target
from ..data.augment import augment_pipe, sample_augment_labels
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import _randn
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["EDM"]

log = logging.getLogger(__name__)


@register_target("diffusion_model_nemo.models.EDM", "diffusion_model_nemo_tpu.models.EDM")
class EDM(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.diffusion_model = self.build_network()
        self.sampler = instantiate(self.cfg.sampler, device=self.device)
        self.loss = instantiate(self.cfg.loss)
        if abs(float(self.loss.sigma_data) - float(self.sampler.sigma_data)) > 1e-9:
            raise ValueError(
                "loss.sigma_data and sampler.sigma_data must match "
                f"(got {self.loss.sigma_data} vs {self.sampler.sigma_data})"
            )
        self.augment_prob = float(self.cfg.get("augment_prob", 0.0) or 0.0)
        self.augment_kwargs = dict(self.cfg.get("augment_kwargs") or {})
        if self.augment_prob > 0.0 and not getattr(self.diffusion_model, "aug_dim", 0):
            raise ValueError(
                "augment_prob > 0 needs a descriptor input on the network: "
                "set model.diffusion_model.aug_dim: 9 (data/augment.AUGMENT_DIM)"
            )
        self.init_params()

    def _bind_classes(self, fn, labels: Optional[torch.Tensor]):
        """``fn`` with per-call labels bound; the base family has no class
        conditioning and ignores them (``ConditionalEDM`` binds them)."""
        del labels
        return fn

    # ---- training ------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, H, W, C]: the flip
        mask (p = 0.5), the standard normal ``sigma_z`` [B], the noise, the
        augmentation descriptor under ``augment_prob`` and each dropout
        site's keep mask."""
        B = shape[0]
        dev = self.device
        draws = {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "sigma_z": _randn((B,), generator, dev),
            "noise": _randn(tuple(shape), generator, dev),
        }
        if self.augment_prob > 0.0:
            draws["augment"] = sample_augment_labels(generator, B, self.augment_prob, device=dev,
                                                     **self.augment_kwargs)
        draws.update(self.draw_dropout_masks(shape, generator))
        return draws

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """EDM eq. 2 / 6 on a raw uint8 batch with the step's draws: the
        flip, the augmentation (the target is the augmented image), x_σ =
        x0 + σε, the λ-weighted MSE of the preconditioned denoiser."""
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        samples, aug = proc["pixel_values"], None
        if self.augment_prob > 0.0:
            samples, aug = augment_pipe(samples, draws["augment"], self.augment_prob)
        model_fn = self.get_model_fn(proc, training=True, label_mask=draws.get("label_mask"),
                                     dropout_masks=self.dropout_masks(draws), aug_cond=aug)
        sigma = self.sampler.sigmas_from_normal(draws["sigma_z"])
        x_sigma = self.sampler.q_sample(samples, sigma, draws["noise"])
        denoised = self.sampler.denoise(model_fn, params, x_sigma, sigma, clip=False)
        loss = self.loss(input=denoised, target=samples, sigma=sigma)
        return loss, {"train_loss": loss}

    # ---- evaluation -----------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None,
                  sigma_z: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                  epsilon: Optional[torch.Tensor] = None, graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Held-out λ-weighted denoising loss of a raw uint8 batch (no flip),
        summed, with σ's normal draws and the noise from ``generator`` (or
        injected); under ``compute_nll`` also the ODE bits/dim, summed, and
        its NFE (the probe drawn after them, or ``epsilon``). A conditional
        model's network sees the batch's labels."""
        proc = preprocess_batch(batch, self.device)
        samples = proc["pixel_values"]
        labels = proc.get("label")
        labels = labels.to(torch.int32) if labels is not None else None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(batch_nb))
        B = samples.shape[0]
        z = _randn((B,), generator, self.device) if sigma_z is None else sigma_z.to(self.device)
        eps = _randn(tuple(samples.shape), generator, self.device) if noise is None else noise.to(self.device)
        with torch.inference_mode():
            sigma = self.sampler.sigmas_from_normal(z)
            x_sigma = self.sampler.q_sample(samples, sigma, eps)
            denoised = self.sampler.denoise(self._bind_classes(self.model_fn, labels), self.params, x_sigma, sigma,
                                            clip=False)
            per_sample = self.loss.weight(sigma) * torch.mean((denoised - samples) ** 2, dim=(1, 2, 3))
        out = {"edm_loss_sum": per_sample.sum(), "num_samples": B}
        if bool(self.cfg.get("compute_nll", False)):
            bpd, _z, nfe = self.likelihood(samples, generator=generator, labels=labels, epsilon=epsilon,
                                           graphs=graphs)
            out["bpds"] = bpd.sum()
            out["nfe"] = nfe
        return out

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = max(float(sum(o["num_samples"] for o in outputs)), 1.0)
        result = {"test_edm_loss": float(sum(float(o["edm_loss_sum"]) for o in outputs)) / total}
        if outputs and "bpds" in outputs[0]:
            result["test_total_bpd"] = float(sum(float(o["bpds"]) for o in outputs)) / total
            result["avg_num_forward_evaluations"] = (
                float(sum(float(o["nfe"]) for o in outputs)) / max(len(outputs), 1))
        log.info(f"EDM test: {result}")
        return result

    def likelihood(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   num_steps: Optional[int] = None, hutchinson_type: str = "rademacher", use_ema: bool = False,
                   labels: Optional[torch.Tensor] = None, epsilon: Optional[torch.Tensor] = None,
                   graphs: Optional[bool] = None):
        """NLL in bits/dim through the probability-flow ODE (``x`` in [−1,
        1]; ``labels`` [B] condition a class-conditional family): (bpd [B],
        latent z, NFE). The probe comes from ``generator`` (default seeded
        0) or ``epsilon``."""
        if generator is None and epsilon is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.ema_params if use_ema else self.params
        return self.sampler.likelihood(self._bind_classes(self.train_model_fn, labels), params,
                                       x.to(self.device), generator=generator, num_steps=num_steps,
                                       hutchinson_type=hutchinson_type, epsilon=epsilon, graphs=graphs)

    def calculate_bits_per_dimension(self, x_start: torch.Tensor, params=None,
                                     generator: Optional[torch.Generator] = None, max_batch_size: int = 32,
                                     graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """The probability-flow NLL of the first ``max_batch_size`` images
        under the Trainer's ``total_bpd`` key (and ``nfe``). Foreign
        ``params`` raise, as in the JAX package: use
        ``likelihood(use_ema=True)`` for the EMA weights."""
        if params is not None and params is not self.params:
            raise NotImplementedError(
                "EDM.calculate_bits_per_dimension uses the model's own params; "
                "use likelihood(use_ema=True) for the EMA weights"
            )
        if max_batch_size > 0:
            x_start = x_start[: min(max_batch_size, x_start.shape[0])]
        bpd, _z, nfe = self.likelihood(x_start, generator=generator, graphs=graphs)
        return {"total_bpd": bpd, "nfe": nfe}

    # ---- sampling services -----------------------------------------------------
    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        use_ema: bool = False,
        return_frames: bool = False,
        num_steps: Optional[int] = None,
        graphs: Optional[bool] = None,
        noise: Optional[torch.Tensor] = None,
        model_fn=None,
    ):
        """Algorithm 2 (the sampler's solver, grid and churn; ``num_steps``
        overrides the grid size): [B, H, W, C] in [0, 1], and with
        ``return_frames`` the trajectory [M, B, H, W, C]. ``noise``
        injects the churn draws; ``model_fn`` substitutes a bound network
        (the conditional family's)."""
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(model_fn or self.get_model_fn(), params, shape, generator,
                                              num_steps=num_steps, return_frames=return_frames, graphs=graphs,
                                              noise=noise)

    def encode(self, x0: torch.Tensor, num_steps: Optional[int] = None, use_ema: bool = False,
               graphs: Optional[bool] = None) -> torch.Tensor:
        """Data ([−1, 1]) → latent by the probability-flow ODE (deterministic)."""
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.encode(self.get_model_fn(), params, x0.to(self.device), num_steps, graphs=graphs)

    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None, lambd: float = 0.5,
                    generator: Optional[torch.Generator] = None, graphs: Optional[bool] = None,
                    noise: Optional[torch.Tensor] = None):
        """Latent interpolation by ODE inversion (encode → slerp → decode)
        of two batches in [0, 1], with the model's weights (not the EMA's,
        as in the JAX package); ``t`` overrides the grid size; ``generator``
        or ``noise`` feed the decode's churn."""
        if x1.ndim != 4 or x2.ndim != 4:
            raise ValueError(f"x1 and x2 must be batches of images, got {list(x1.shape)} and {list(x2.shape)}")
        with torch.inference_mode():
            return self.sampler.interpolate(self.get_model_fn(), self.params, x1.to(self.device),
                                            x2.to(self.device), generator, t=t, lambd=lambd, graphs=graphs,
                                            noise=noise)

