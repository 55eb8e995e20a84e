"""SDE correctors: the registry, Langevin and annealed Langevin dynamics.

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_correctors.py``, with
its registry names. ``update_fn(params, x, t, z)`` takes its ``n_steps``
normals as a tensor [n_steps, *x.shape] (the JAX correctors split a key per
inner step). Returns (x, x_mean).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import torch

from .sde_lib.sde_lib import SDE, batch_mul, take
from .sde_lib.sub_vp_sde import subVPSDE
from .sde_lib.ve_sde import VESDE
from .sde_lib.vp_sde import VPSDE

__all__ = [
    "Corrector",
    "NoneCorrector",
    "LangevinCorrector",
    "AnnealedLangevinDynamics",
    "CORRECTOR_REGISTRY",
    "register_corrector",
    "get_corrector",
]

CORRECTOR_REGISTRY: Dict[str, Type["Corrector"]] = {}


def register_corrector(cls: Type["Corrector"], name: Optional[str] = None) -> None:
    name = name or cls.__name__
    if name in CORRECTOR_REGISTRY and CORRECTOR_REGISTRY[name] is not cls:
        raise ValueError(f"Corrector {name} has already been registered !")
    CORRECTOR_REGISTRY[name] = cls


def get_corrector(name: Optional[str]) -> Optional[Type["Corrector"]]:
    if name is None:
        return None
    return CORRECTOR_REGISTRY.get(name)


class Corrector:
    def __init__(self, sde: SDE, score_fn, snr: float, n_steps: int):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    @property
    def draws(self) -> int:
        return int(self.n_steps)

    def update_fn(self, params: Any, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor):
        raise NotImplementedError()

    @classmethod
    def register_corrector(cls, name: Optional[str] = None) -> None:
        if get_corrector(name or cls.__name__) is None:
            register_corrector(cls, name=name)

    # the reference's spelling (base_corrector.py ``register_corector``)
    register_corector = register_corrector


class NoneCorrector(Corrector):
    draws = 0

    def __init__(self, sde=None, score_fn=None, snr=0.0, n_steps=0):
        pass

    def update_fn(self, params, x, t, z=None):
        return x, x


def _alpha_for(sde: SDE, t: torch.Tensor) -> torch.Tensor:
    """α_i from VPSDE's table; 1 − β(t)/N for sub-VP (no table); 1 for VE."""
    if isinstance(sde, (VPSDE, subVPSDE)):
        timestep = (t * (sde.N - 1) / sde.T).to(torch.int32)
        if hasattr(sde, "alphas"):
            return take(sde.alphas, timestep)
        beta_t = sde.beta_0 + t * (sde.beta_1 - sde.beta_0)
        return 1.0 - beta_t / sde.N
    return torch.ones_like(t)


def _batch_mean_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


class LangevinCorrector(Corrector):
    """``n_steps`` of Langevin MCMC; the step size from the target SNR and
    the batch-mean norms of the score and the noise."""

    def __init__(self, sde, score_fn, snr, n_steps):
        super().__init__(sde, score_fn, snr, n_steps)
        if not isinstance(sde, (VPSDE, VESDE, subVPSDE)):
            raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")

    def update_fn(self, params, x, t, z):
        alpha = _alpha_for(self.sde, t)
        x_mean = x
        for i in range(self.n_steps):
            grad = self.score_fn(params, x, t)
            noise = z[i]
            grad_norm = _batch_mean_norm(grad)
            noise_norm = _batch_mean_norm(noise)
            step_size = (self.snr * noise_norm / grad_norm) ** 2 * 2 * alpha
            x_mean = x + batch_mul(step_size, grad)
            x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
        return x, x_mean


class AnnealedLangevinDynamics(Corrector):
    """NCSN's annealed Langevin dynamics: the step size from the marginal std."""

    def __init__(self, sde, score_fn, snr, n_steps):
        super().__init__(sde, score_fn, snr, n_steps)
        if not isinstance(sde, (VPSDE, VESDE, subVPSDE)):
            raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")

    def update_fn(self, params, x, t, z):
        alpha = _alpha_for(self.sde, t)
        std = self.sde.marginal_prob(x, t)[1]
        x_mean = x
        for i in range(self.n_steps):
            grad = self.score_fn(params, x, t)
            step_size = (self.snr * std) ** 2 * 2 * alpha
            x_mean = x + batch_mul(step_size, grad)
            x = x_mean + batch_mul(torch.sqrt(step_size * 2), z[i])
        return x, x_mean


NoneCorrector.register_corrector("none")
NoneCorrector.register_corrector("null")
LangevinCorrector.register_corrector("langevin")
AnnealedLangevinDynamics.register_corrector("ald")
