"""WaveGrad's continuous-noise-level diffusion and its short-schedule search.

Counterpart of ``diffusion_model_nemo_tpu/modules/wavegrad_diffusion.py``:
training conditions the network on a continuous √ᾱ drawn between two
adjacent entries of the schedule, and sampling conditions it on
√ᾱ_{t+1}; for fast sampling a short schedule (e.g. 50 steps) is searched
whose last √ᾱ matches the long one, then the inherited ancestral chain runs
at the short length. The JAX step draws the level inside the jitted step;
here the draws (the index ``s`` in [1, T] and ``u`` in [0, 1)) are tensors
the caller makes, so a test can feed both packages the same ones. The
search runs on the host in numpy, as in the JAX package.

The constant table of the original schedule is kept: restoring the
original T and schedule after a short-schedule sample (the training dump,
``eval``) returns the same table tensors, so the graphs captured on them
(the training step, the 1000-step chain) stay valid.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops.schedules import extract, get_named_beta_schedule
from .gaussian_diffusion import GaussianDiffusion, PMeanVariance

__all__ = ["WaveGradDiffusion", "last_sqrt_alpha_cumprod"]

log = logging.getLogger(__name__)


def last_sqrt_alpha_cumprod(timesteps: int, schedule_name: str, schedule_cfg: Dict[str, Any]) -> float:
    """The last entry of the table's ``sqrt_alphas_cumprod_prev`` (float32)
    for a schedule, computed as ``ops.schedules.compute_schedule_constants``
    computes it (float64 on the host, one rounding), without the rest of
    the table."""
    betas = get_named_beta_schedule(schedule_name, timesteps, schedule_cfg).astype(np.float64)
    return float(np.float32(np.sqrt(np.cumprod(1.0 - betas)[-1])))


@register_target("diffusion_model_nemo.modules.WaveGradDiffusion")
class WaveGradDiffusion(GaussianDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        class_conditional: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if objective == "pred_v":
            # The level is continuous: the discrete v tables do not apply.
            raise ValueError("WaveGradDiffusion supports pred_noise|pred_x0 only")
        super().__init__(timesteps, schedule_name, schedule_cfg, objective, class_conditional, device=device)
        self.original_timesteps = int(timesteps)
        self.original_schedule_name = schedule_name
        self.original_schedule_cfg = copy.deepcopy(self.schedule_cfg)
        self._original_constants = self.constants

    def compute_constants(self, timesteps: int) -> None:
        """As the base class; the original schedule's table is the one kept
        from construction (the same tensors)."""
        original = getattr(self, "_original_constants", None)
        if (original is not None and int(timesteps) == self.original_timesteps
                and self.schedule_name == self.original_schedule_name
                and self.schedule_cfg == self.original_schedule_cfg):
            self.timesteps, self.constants = int(timesteps), original
            return
        super().compute_constants(timesteps)

    # ---- schedule hot-swap ---------------------------------------------------
    def change_noise_schedule(self, schedule_name: Optional[str] = None, schedule_cfg: Optional[dict] = None,
                              reset_cfg: bool = False, verbose: bool = True) -> None:
        """Swap the schedule config (``reset_cfg``: back to the original);
        ``compute_constants`` makes it take effect."""
        if reset_cfg:
            self.schedule_name = self.original_schedule_name
            self.schedule_cfg = copy.deepcopy(self.original_schedule_cfg)
        if schedule_name is not None:
            self.schedule_name = schedule_name
        if schedule_cfg is not None:
            self.schedule_cfg = schedule_cfg
        if verbose:
            log.info(f"New scheduler name : {self.schedule_name}")
            log.info(f"New scheduler config : {self.schedule_cfg}")

    def search_noise_schedule_coefficients(self, timesteps: int, iters: int = 100, seed: Optional[int] = None,
                                           verbose: bool = True) -> None:
        """Random search over the schedule's end (``beta_end``, or
        ``max_clip`` for cosine) so that the ``timesteps``-step schedule's
        last √ᾱ matches the original schedule's; draws from
        ``np.random.RandomState(seed)``, as the JAX package does. The best
        value is written into ``schedule_cfg`` (the schedule's own dict,
        which the model's config shares, as in the JAX package)."""
        self.compute_constants(self.original_timesteps)
        target = last_sqrt_alpha_cumprod(self.timesteps, self.schedule_name, self.schedule_cfg)
        if self.schedule_name == "cosine":
            beta_end_key = "max_clip"
        elif self.schedule_name in ("linear", "quadratic", "sigmoid"):
            beta_end_key = "beta_end"
        else:
            raise ValueError("Unknown schedule name !")
        sched = self.schedule_cfg.setdefault(self.schedule_name, {})
        best_beta_end = sched.get(beta_end_key, 0.02)
        best_mae = 1e10
        rng = np.random.RandomState(seed)
        for _ in range(iters):
            sampled = float(rng.uniform(0.0, 1.0))
            sched[beta_end_key] = sampled
            mae = abs(target - last_sqrt_alpha_cumprod(timesteps, self.schedule_name, self.schedule_cfg))
            if mae < best_mae:
                if verbose:
                    log.info(f"Searching coefficient: found beta2={sampled} (error: {mae} < {best_mae})")
                best_mae, best_beta_end = mae, sampled
        sched[beta_end_key] = best_beta_end
        if verbose:
            log.info(f"Searching coefficient: final beta2 = {best_beta_end}")

    def use_searched_schedule(self, timesteps: int, iters: int, seed: int = 0) -> None:
        """Search a ``timesteps``-step schedule and sample on it (the JAX
        scripts' search, ``change_noise_schedule``, ``compute_constants``)."""
        self.search_noise_schedule_coefficients(timesteps=timesteps, iters=iters, seed=seed, verbose=False)
        self.change_noise_schedule(verbose=False)
        self.compute_constants(timesteps)

    def restore_schedule(self) -> None:
        """Back to the original schedule and T (the table kept from
        construction)."""
        self.change_noise_schedule(reset_cfg=True, verbose=False)
        self.compute_constants(self.original_timesteps)

    # ---- continuous noise level ----------------------------------------------
    def sample_continuous_noise_level(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """√ᾱ between two adjacent schedule points: ``lo + u·(hi − lo)`` with
        lo, hi the table's ``sqrt_alphas_cumprod_prev`` at s − 1 and s
        (gathered on the device). ``s``: [B] int in [1, T]; ``u``: [B] in
        [0, 1). Returns [B, 1, 1, 1]."""
        table = self.constants.sqrt_alphas_cumprod_prev
        s = s.to(device=table.device, dtype=torch.long)
        lo, hi = table.gather(0, s - 1), table.gather(0, s)
        return (lo + u.to(table.device) * (hi - lo)).reshape(-1, 1, 1, 1)

    def q_sample_continuous(self, x_start: torch.Tensor, continuous_sqrt_alpha_cumprod: torch.Tensor,
                            noise: torch.Tensor) -> torch.Tensor:
        """Forward noising at a continuous √ᾱ: level·x₀ + √(1 − level²)·ε."""
        level = continuous_sqrt_alpha_cumprod
        return level * x_start + torch.sqrt(1.0 - level**2) * noise

    def q_sample(self, x_start, t_or_level, noise):
        """An integer ``t`` (a Python int or an integer tensor) is the
        discrete forward process; a float one a continuous level."""
        if isinstance(t_or_level, int) or (torch.is_tensor(t_or_level) and not t_or_level.is_floating_point()):
            return super().q_sample(x_start, t_or_level, noise)
        return self.q_sample_continuous(x_start, t_or_level, noise)

    def predict_start_from_noise(self, x_t, t, noise):
        """With ``sqrt_alphas_cumprod_m1``, as the reference has it."""
        c = self.constants
        return (
            extract(c.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_alphas_cumprod_m1, t, noise.ndim) * noise
        )

    def noise_level(self, x: torch.Tensor, t) -> torch.Tensor:
        """The network's level at step t: √ᾱ_{t+1} of the table, [B, 1, ...]
        (a scalar t broadcast over the batch; a 0-d device t gathered on the
        device, as a capture needs)."""
        t1 = t + 1
        level = extract(self.constants.sqrt_alphas_cumprod_prev, t1, x.ndim)
        if not torch.is_tensor(t) or t.ndim == 0:
            level = level.expand((x.shape[0],) + (1,) * (x.ndim - 1))
        return level

    def p_mean_variance(self, model_fn, params: Any, x, t, model_output=None) -> PMeanVariance:
        """The reverse step with the network conditioned on √ᾱ_{t+1}."""
        if model_output is None:
            model_output = model_fn(params, x, self.noise_level(x, t))
        if self.objective == "pred_noise":
            x_recon = self.predict_start_from_noise(x, t, model_output)
        else:
            x_recon = model_output
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_variance = self.q_posterior(x_recon, x, t)
        return PMeanVariance(mean, None, log_variance, x_recon)
