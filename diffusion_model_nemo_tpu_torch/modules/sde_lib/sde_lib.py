"""Abstract SDE classes and the reverse-time SDE/ODE.

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/sde_lib.py``.
Score functions carry the parameters explicitly, ``score_fn(params, x, t)``;
``reverse()`` returns a holder of the reverse drift and discretization.
``t`` is a [B] tensor or a 0-d tensor (the samplers' fast path: one t for
the whole batch, as in the JAX package). Random draws come from a
``torch.Generator`` or are injected as tensors. Every SDE keeps its tables
on the device it was built for.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["SDE", "ReverseSDE", "batch_mul", "jax_linspace", "take"]

ScoreFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


def batch_mul(a, x: torch.Tensor) -> torch.Tensor:
    """Per-sample scalars ``a`` [B] (or a 0-d tensor or a number: one value
    for the whole batch) times ``x`` [B, ...]."""
    if not torch.is_tensor(a) or a.ndim == 0:
        return a * x
    return a.reshape(a.shape[0], *((1,) * (x.ndim - 1))) * x


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer tensor ``idx`` of any shape, 0-d
    included, gathered on the device (indexing with a 0-d tensor reads it
    on the host, which a CUDA graph's capture forbids)."""
    return table.gather(0, idx.reshape(-1).to(torch.long)).reshape(idx.shape)


def jax_linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num, dtype=float32)`` in JAX's float32
    arithmetic: ``start·(1 − i/div) + stop·(i/div)``, each operation
    rounded, and the last value ``stop`` (JAX's result op by op, bit for bit;
    ``torch.linspace`` puts a third of the values of ``linspace(1, 1e-3,
    1000)`` an ulp away, and XLA:CPU's compiled program, which folds 1/div
    and contracts into FMAs, up to a few)."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.asarray([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


def gaussian_prior_logp(z: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """log N(z; 0, σ²I) per sample [B]."""
    N = int(np.prod(z.shape[1:]))
    return -N / 2.0 * math.log(2 * math.pi * sigma**2) - torch.sum(z**2, dim=tuple(range(1, z.ndim))) / (2 * sigma**2)


class ReverseSDE:
    """Reverse-time SDE/ODE of a forward SDE and a score function: drift ←
    drift − G²·score (½ of it for the probability-flow ODE, whose diffusion
    is zero)."""

    def __init__(self, fsde: "SDE", score_fn: ScoreFn, probability_flow: bool = False):
        self.fsde = fsde
        self.score_fn = score_fn
        self.probability_flow = probability_flow
        self.N = fsde.N
        self.T = fsde.T

    def sde(self, params: Any, x: torch.Tensor, t: torch.Tensor):
        drift, diffusion = self.fsde.sde(x, t)
        score = self.score_fn(params, x, t)
        factor = 0.5 if self.probability_flow else 1.0
        drift = drift - batch_mul(diffusion**2, score) * factor
        diffusion = torch.zeros_like(diffusion) if self.probability_flow else diffusion
        return drift, diffusion

    def discretize(self, params: Any, x: torch.Tensor, t: torch.Tensor):
        f, G = self.fsde.discretize(x, t)
        factor = 0.5 if self.probability_flow else 1.0
        rev_f = f - batch_mul(G**2, self.score_fn(params, x, t)) * factor
        rev_G = torch.zeros_like(G) if self.probability_flow else G
        return rev_f, rev_G


class SDE(abc.ABC):
    """An SDE on mini-batches; ``sampling_epsilon`` is a class variable."""

    sampling_epsilon: float = None

    def __init__(self, N: int, device: Union[str, torch.device] = "cuda"):
        if self.sampling_epsilon is None:
            raise ValueError("Sampling epsilon cannot be None ! Must be set as a class variable !")
        self.N = int(N)
        self.device = torch.device(device)

    @property
    @abc.abstractmethod
    def T(self) -> float:
        """End time of the SDE."""

    @abc.abstractmethod
    def sde(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward drift f(x, t) and diffusion g(t)."""

    @abc.abstractmethod
    def marginal_prob(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of the marginal p_t(x)."""

    @abc.abstractmethod
    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Prior log-density per sample, for the likelihood."""

    prior_std: float = 1.0

    def prior_sampling(self, shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """One sample of the prior p_T: N(0, prior_std²I)."""
        z = torch.randn(tuple(shape), generator=generator, device=device or self.device, dtype=torch.float32)
        return z if self.prior_std == 1.0 else z * self.prior_std

    def discretize(self, x: torch.Tensor, t: torch.Tensor):
        """Euler–Maruyama: x_{i+1} = x_i + f_i + G_i z_i."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        f = drift * dt
        G = diffusion * float(np.sqrt(np.float32(dt)))
        return f, G

    def reverse(self, score_fn: ScoreFn, probability_flow: bool = False) -> ReverseSDE:
        return ReverseSDE(self, score_fn, probability_flow)

    def time_grid(self, eps: float, device=None) -> torch.Tensor:
        """The samplers' grid T → eps, N float32 values (the JAX grid)."""
        return torch.from_numpy(jax_linspace(self.T, eps, self.N)).to(device or self.device)
