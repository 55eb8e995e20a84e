"""Rectified-flow / flow-matching model: network + ``RectifiedFlowProcess``
+ loss from the config, the training step, evaluation, the exact NLL and
the sampling services.

Counterpart of ``diffusion_model_nemo_tpu/models/rectified_flow.py``. The
JAX step splits one key into the flip, t, noise and dropout draws; here
``draw_training_inputs`` draws them from a ``torch.Generator`` and
``training_step`` takes them as tensors: ``flip`` [B], ``time`` [B] (u, or
the normal z of ``logit_normal``: ``RectifiedFlowProcess.sample_times``),
``noise`` and the dropout masks, so the whole step is one captured graph on
CUDA. The step regresses the path velocity ε − x0 through the config's
``DiffusionLoss``.

``test_step`` reports the held-out flow-matching loss (``test_fm_loss``)
and, unless ``compute_nll: false``, the exact change-of-variables bits/dim
and its NFE; ``calculate_bits_per_dimension`` (the Trainer's
``compute_bpd`` dump) is that NLL with the model's own weights only, as in
the JAX package. ``sample`` (``num_steps``, ``return_frames``), ``encode``
and ``interpolate`` run captured loops on CUDA; ``mesh=`` is not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import instantiate, register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import _randn
from ..modules.parts import not_ported
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["RectifiedFlow"]

log = logging.getLogger(__name__)


@register_target("diffusion_model_nemo.models.RectifiedFlow", "diffusion_model_nemo_tpu.models.RectifiedFlow")
class RectifiedFlow(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.diffusion_model = self.build_network()
        self.sampler = instantiate(self.cfg.sampler, device=self.device)
        self.loss = instantiate(self.cfg.loss)
        self.init_params()

    def _example_time(self) -> torch.Tensor:
        """A representative conditioning value: mid-path, scaled."""
        return torch.full((1,), 0.5 * float(self.sampler.time_scale), dtype=torch.float32, device=self.device)

    # ---- training ------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, H, W, C]: the flip
        mask (p = 0.5), the time draw [B], the noise and each dropout site's
        keep mask."""
        B = shape[0]
        draws = {
            "flip": torch.rand((B,), generator=generator, device=self.device) < 0.5,
            "time": self.sampler.draw_times(B, generator),
            "noise": _randn(tuple(shape), generator, self.device),
        }
        draws.update(self.draw_dropout_masks(shape, generator))
        return draws

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Conditional flow matching on a raw uint8 batch with the step's
        draws: the flip, x_t on the linear path at the drawn t, the loss of
        the network's velocity against ε − x0."""
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        samples = proc["pixel_values"]
        model_fn = self.get_model_fn(proc, training=True, dropout_masks=self.dropout_masks(draws))
        t = self.sampler.sample_times(draws["time"])
        x_t = self.sampler.q_sample(samples, t, draws["noise"])
        out = model_fn(params, x_t, self.sampler.model_time(t))
        loss = self.loss(input=out, target=self.sampler.v_target(samples, draws["noise"]))
        return loss, {"train_loss": loss}

    # ---- evaluation -----------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None,
                  time: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                  epsilon: Optional[torch.Tensor] = None, graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Held-out flow-matching loss of a raw uint8 batch (no flip), the
        per-sample MSE summed, with the time draw and the noise from
        ``generator`` (or injected); unless ``compute_nll: false`` also the
        exact bits/dim, summed, and its NFE (the probe drawn after them, or
        ``epsilon``)."""
        samples = preprocess_batch(batch, self.device)["pixel_values"]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(batch_nb))
        B = samples.shape[0]
        u = self.sampler.draw_times(B, generator) if time is None else time.to(self.device)
        eps = _randn(tuple(samples.shape), generator, self.device) if noise is None else noise.to(self.device)
        with torch.inference_mode():
            t = self.sampler.sample_times(u)
            out = self.model_fn(self.params, self.sampler.q_sample(samples, t, eps), self.sampler.model_time(t))
            per_sample = torch.mean((out - self.sampler.v_target(samples, eps)) ** 2, dim=(1, 2, 3))
        result = {"fm_loss_sum": per_sample.sum(), "num_samples": B}
        if bool(self.cfg.get("compute_nll", True)):
            bpd, _z, nfe = self.likelihood(samples, generator=generator, epsilon=epsilon, graphs=graphs)
            result["bpds"] = bpd.sum()
            result["nfe"] = nfe
        return result

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = max(float(sum(o["num_samples"] for o in outputs)), 1.0)
        result = {"test_fm_loss": float(sum(float(o["fm_loss_sum"]) for o in outputs)) / total}
        if outputs and "bpds" in outputs[0]:
            result["test_total_bpd"] = float(sum(float(o["bpds"]) for o in outputs)) / total
            result["avg_num_forward_evaluations"] = (
                float(sum(float(o["nfe"]) for o in outputs)) / max(len(outputs), 1))
        log.info(f"RectifiedFlow test: {result}")
        return result

    def likelihood(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   num_steps: Optional[int] = None, hutchinson_type: str = "rademacher", use_ema: bool = False,
                   epsilon: Optional[torch.Tensor] = None, graphs: Optional[bool] = None):
        """Exact NLL in bits/dim (``x`` in [−1, 1]): (bpd [B], latent z, NFE).
        The probe comes from ``generator`` (default seeded 0) or ``epsilon``."""
        if generator is None and epsilon is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.ema_params if use_ema else self.params
        return self.sampler.likelihood(self.train_model_fn, params, x.to(self.device), generator=generator,
                                       num_steps=num_steps, hutchinson_type=hutchinson_type, epsilon=epsilon,
                                       graphs=graphs)

    def calculate_bits_per_dimension(self, x_start: torch.Tensor, params=None,
                                     generator: Optional[torch.Generator] = None, max_batch_size: int = 32,
                                     graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """The exact NLL of the first ``max_batch_size`` images under the
        Trainer's ``total_bpd`` key (and ``nfe``). Foreign ``params`` raise,
        as in the JAX package: use ``likelihood(use_ema=True)`` for the EMA
        weights."""
        if params is not None and params is not self.params:
            raise NotImplementedError(
                "RectifiedFlow.calculate_bits_per_dimension uses the model's own params; "
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
        mesh=None,
        shard_axis: str = "batch",
        graphs: Optional[bool] = None,
    ):
        """The ODE from N(0, I) noise drawn from ``generator`` (the sampler's
        solver; ``num_steps`` overrides the grid size): [B, H, W, C] in [0,
        1], and with ``return_frames`` the trajectory [M, B, H, W, C]."""
        if mesh is not None or shard_axis != "batch":
            raise not_ported("RectifiedFlow.sample", "mesh= / shard_axis=", "parallelism")
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(self.get_model_fn(), params, shape, generator, num_steps=num_steps,
                                              return_frames=return_frames, graphs=graphs)

    def encode(self, x0: torch.Tensor, num_steps: Optional[int] = None, use_ema: bool = False,
               graphs: Optional[bool] = None) -> torch.Tensor:
        """Data ([−1, 1]) → latent by the same ODE forward (deterministic)."""
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.encode(self.get_model_fn(), params, x0.to(self.device), num_steps, graphs=graphs)

    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None, lambd: float = 0.5,
                    generator: Optional[torch.Generator] = None, graphs: Optional[bool] = None):
        """Latent interpolation by exact ODE inversion (encode → slerp →
        decode) of two batches in [0, 1], with the model's weights (not the
        EMA's, as in the JAX package); ``t`` overrides the grid size."""
        if x1.ndim != 4 or x2.ndim != 4:
            raise ValueError(f"x1 and x2 must be batches of images, got {list(x1.shape)} and {list(x2.shape)}")
        with torch.inference_mode():
            return self.sampler.interpolate(self.get_model_fn(), self.params, x1.to(self.device),
                                            x2.to(self.device), generator, t=t, lambd=lambd, graphs=graphs)
