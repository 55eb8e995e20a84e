"""SDE predictors: the registry, Euler–Maruyama, reverse diffusion and
ancestral sampling (VP and VE).

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_predictors.py``, with
its registry names. ``update_fn(params, x, t, z)`` takes the step's noise
``z`` as a tensor (the JAX predictors draw it from a key): a sampler draws
it, or a test injects the JAX draw. ``z=None`` returns ``x_mean`` for both
outputs (a denoising step that needs no draw). Returns (x, x_mean).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from .sde_lib.sde_lib import SDE, batch_mul, take
from .sde_lib.ve_sde import VESDE, adjacent
from .sde_lib.vp_sde import VPSDE

__all__ = [
    "Predictor",
    "NonePredictor",
    "EulerMaruyamaPredictor",
    "ReverseDiffusionPredictor",
    "AncestralSamplingPredictor",
    "PREDICTOR_REGISTRY",
    "register_predictor",
    "get_predictor",
]

PREDICTOR_REGISTRY: Dict[str, Type["Predictor"]] = {}


def register_predictor(cls: Type["Predictor"], name: Optional[str] = None) -> None:
    name = name or cls.__name__
    if name in PREDICTOR_REGISTRY and PREDICTOR_REGISTRY[name] is not cls:
        raise ValueError(f"Predictor {name} has already been registered !")
    PREDICTOR_REGISTRY[name] = cls


def get_predictor(name: Optional[str]) -> Optional[Type["Predictor"]]:
    if name is None:
        return None
    return PREDICTOR_REGISTRY.get(name)


def _noised(x_mean: torch.Tensor, scale, z: Optional[torch.Tensor]) -> torch.Tensor:
    return x_mean if z is None else x_mean + batch_mul(scale, z)


class Predictor:
    """One reverse step; ``draws`` is the number of normals it takes."""

    draws = 1

    def __init__(self, sde: SDE, score_fn, probability_flow: bool = False):
        self.sde = sde
        self.rsde = sde.reverse(score_fn, probability_flow)
        self.score_fn = score_fn

    def update_fn(self, params: Any, x: torch.Tensor, t: torch.Tensor, z: Optional[torch.Tensor]):
        raise NotImplementedError()

    @classmethod
    def register_predictor(cls, name: Optional[str] = None) -> None:
        if get_predictor(name or cls.__name__) is None:
            register_predictor(cls, name=name)


class NonePredictor(Predictor):
    draws = 0

    def __init__(self, sde=None, score_fn=None, probability_flow=False):
        pass

    def update_fn(self, params, x, t, z=None):
        return x, x


class EulerMaruyamaPredictor(Predictor):
    """x ← x + drift·dt + diffusion·√(−dt)·z, dt = −1/N."""

    def update_fn(self, params, x, t, z):
        dt = -1.0 / self.rsde.N
        drift, diffusion = self.rsde.sde(params, x, t)
        x_mean = x + drift * dt
        if z is None:
            return x_mean, x_mean
        return x_mean + batch_mul(diffusion, z) * float(np.sqrt(np.float32(-dt))), x_mean


class ReverseDiffusionPredictor(Predictor):
    """The discretized reverse step x ← x − f + G·z."""

    def update_fn(self, params, x, t, z):
        f, G = self.rsde.discretize(params, x, t)
        x_mean = x - f
        return _noised(x_mean, G, z), x_mean


class AncestralSamplingPredictor(Predictor):
    """Ancestral updates of a VE or VP SDE on its discrete tables."""

    def __init__(self, sde, score_fn, probability_flow=False):
        super().__init__(sde, score_fn, probability_flow)
        if not isinstance(sde, (VPSDE, VESDE)):
            raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")
        assert not probability_flow, "Probability flow not supported by ancestral sampling"

    def vesde_update_fn(self, params, x, t, z):
        sde = self.sde
        timestep = (t * (sde.N - 1) / sde.T).to(torch.int32)
        sigma, adjacent_sigma = adjacent(sde.discrete_sigmas, timestep, t)
        score = self.score_fn(params, x, t)
        x_mean = x + batch_mul(sigma**2 - adjacent_sigma**2, score)
        std = torch.sqrt((adjacent_sigma**2 * (sigma**2 - adjacent_sigma**2)) / (sigma**2))
        return _noised(x_mean, std, z), x_mean

    def vpsde_update_fn(self, params, x, t, z):
        sde = self.sde
        timestep = (t * (sde.N - 1) / sde.T).to(torch.int32)
        beta = take(sde.discrete_betas, timestep)
        score = self.score_fn(params, x, t)
        x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta), x + batch_mul(beta, score))
        return _noised(x_mean, torch.sqrt(beta), z), x_mean

    def update_fn(self, params, x, t, z):
        if isinstance(self.sde, VESDE):
            return self.vesde_update_fn(params, x, t, z)
        return self.vpsde_update_fn(params, x, t, z)


NonePredictor.register_predictor("none")
NonePredictor.register_predictor("null")
EulerMaruyamaPredictor.register_predictor("euler_maruyama")
ReverseDiffusionPredictor.register_predictor("reverse_diffusion")
AncestralSamplingPredictor.register_predictor("ancestral_sampling")
