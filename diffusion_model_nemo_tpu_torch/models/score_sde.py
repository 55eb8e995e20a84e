"""Continuous-time score SDE model (Song et al. 2021).

Counterpart of ``diffusion_model_nemo_tpu/models/score_sde.py``: the SDE is
chosen by ``cfg.sde.sde_type`` among the ``vpsde`` / ``subvpsde`` /
``vesde`` sub-configs and wired into the sampler (predictor–corrector or
probability flow), the loss and the likelihood estimator; a training step
draws t ~ U(0, 1) (float32 [B], rescaled inside the loss) and the noise,
with the horizontal flip of the data as the JAX step's preprocessing;
``test_step`` reports the probability-flow ODE's bits/dim and its NFE.
The draws are tensors (``draw_training_inputs``), so a test can feed both
packages the same ones. There is no discrete bits/dim: with ``compute_bpd``
the JAX trainer's first sample dump fails on ``sampler.timesteps``, and
``calculate_bits_per_dimension`` here raises a ``ValueError`` at that
point instead.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import instantiate, register_target
from ..config.yaml_config import from_dict, to_yaml
from ..data.hf_vision_data import preprocess_batch
from ..modules.sde_lib.likelihood import LikelihoodEstimate
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["ScoreSDE", "NO_DISCRETE_BPD"]

log = logging.getLogger(__name__)

NO_DISCRETE_BPD = (
    "ScoreSDE has no discrete bits/dim: the JAX package's calculate_bits_per_dimension "
    "(diffusion_model_nemo_tpu/models/abstract_diffusion_model.py:269) reads `sampler.timesteps`, which "
    "{sampler} does not have, so a run with model.compute_bpd=true fails at its first save_every dump "
    "(AttributeError there). Set model.compute_bpd=false; test_score_sde reports the ODE bits/dim."
)


@register_target("diffusion_model_nemo.models.ScoreSDE")
class ScoreSDE(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.continuous = self.cfg.get("continuous", True)
        self.likelihood_weighting = self.cfg.get("likelihood_weighting", False)
        self.diffusion_model = self.build_network()

        sde_type = str(self.cfg.sde.get("sde_type")).lower()
        sde_cfg = self.cfg.sde.get(sde_type)
        if sde_cfg is None:
            raise ValueError(f"sde.sde_type={sde_type!r} names no sub-config of `sde`")
        self.sde = instantiate(sde_cfg, device=self.device)

        self.sampler = instantiate(self.cfg.sampler)
        self.sampler.update_sde(self.sde)

        self.loss = instantiate(self.cfg.loss)
        self.loss.update_sde(self.sde)

        likelihood_cfg = self.cfg.get("likelihood_estimate")
        self.likelihood_estimator = (
            LikelihoodEstimate() if likelihood_cfg is None else instantiate(likelihood_cfg)
        )
        self.likelihood_estimator.update_sde(self.sde)
        self.init_params()

    # ---- training ------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, H, W, C]: the
        horizontal-flip mask (p = 0.5), t ~ U[0, 1) (float32), the noise and
        each dropout site's keep mask. The JAX step reads no other training
        option (no offset noise, no Min-SNR-γ)."""
        B = shape[0]
        dev = self.device
        draws = {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "t": torch.rand((B,), generator=generator, device=dev, dtype=torch.float32),
            "noise": torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32),
        }
        draws.update(self.draw_dropout_masks(shape, generator))
        return draws

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The score-matching loss of a raw uint8 batch with the step's draws."""
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        model_fn = self.get_model_fn(proc, training=True, dropout_masks=self.dropout_masks(draws))
        loss = self.loss(model_fn, params, x_start=proc["pixel_values"], t=draws["t"], noise=draws["noise"])
        return loss, {"train_loss": loss}

    def calculate_bits_per_dimension(self, *args, **kwargs):
        raise ValueError(NO_DISCRETE_BPD.format(sampler=type(self.sampler).__name__))

    # ---- evaluation ----------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None,
                  epsilon: Optional[torch.Tensor] = None, graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """ODE bits/dim of a raw uint8 batch, summed, and the solve's NFE;
        the trace probe is drawn from ``generator`` (or ``epsilon``)."""
        proc = preprocess_batch(batch, self.device)
        samples = proc["pixel_values"]
        bpds, _z, nfe = self.likelihood_estimator.likelihood(
            self.get_model_fn(proc, training=True), self.params, samples, generator=generator,
            epsilon=epsilon, graphs=graphs,
        )
        return {"bpds": bpds.sum(), "nfe": nfe.to(torch.float32), "num_samples": samples.shape[0]}

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = float(sum(o["num_samples"] for o in outputs))
        result = {
            "test_total_bpd": float(sum(float(o["bpds"]) for o in outputs)) / total,
            "avg_num_forward_evaluations": float(sum(float(o["nfe"]) for o in outputs)) / max(len(outputs), 1),
        }
        log.info(f"ScoreSDE test: {result}")
        return result

    # ---- sampling ------------------------------------------------------------
    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        use_ema: bool = False,
        return_nfe: bool = False,
        graphs: Optional[bool] = None,
    ):
        """The sampler's chain (PC) or solve (probability flow): [B, H, W, C]
        in [0, 1] on the model's device (and the NFE). ``graphs``: replay
        captured steps (default: on CUDA) or run the Python loop."""
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.sample(self.get_model_fn(), params, shape, generator,
                                       return_nfe=return_nfe, graphs=graphs)

    def change_sampler(self, sampler_cfg) -> None:
        """Re-instantiate the sampler, wire the SDE into it, keep its config."""
        sampler_cfg = from_dict(sampler_cfg)
        self.sampler = instantiate(sampler_cfg)
        self.sampler.update_sde(self.sde)
        self.cfg["sampler"] = sampler_cfg
        log.info(f"Sampler config changed to :\n{to_yaml(sampler_cfg)}")

