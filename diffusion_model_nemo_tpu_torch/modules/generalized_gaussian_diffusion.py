"""Generalized (DDIM) sampler, Song et al. 2020, eq. 12.

Counterpart of
``diffusion_model_nemo_tpu/modules/generalized_gaussian_diffusion.py``:
``eta`` in [0, 1] (0 = DDIM), ``ddim_timesteps`` strided subsampling, and
the ᾱ table extended with a leading 1.0 so that t = −1 maps to ᾱ = 1
(indexed at t + 1). With ``eta = 0`` the noise term is exactly zero and no
noise is drawn. The JAX package's chain is one ``lax.scan``; here, on CUDA,
it is replays of one captured ``ddim_step`` (``ops/graphs.py``) that reads
(t, t_next) from its device table at a device step counter, with x_T and
any noise drawn eagerly, in the eager loop's order, into static buffers
(``table_loop``, the chain of the solvers that subclass it).

A learned-variance network's output ([B, H, W, 2C]) raises ``ValueError``:
the JAX package's DDIM step reshapes the output to x's shape and fails
there too (a ``TypeError`` from the reshape); the port names the cause.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from ..ops.schedules import extract
from .diffusion_process import ModelFn
from .gaussian_diffusion import GaussianDiffusion, PMeanVariance, _randn, batched_t, new_frames
from .table_loop import device_table, table_loop

__all__ = ["GeneralizedGaussianDiffusion"]


@register_target("diffusion_model_nemo.modules.GeneralizedGaussianDiffusion")
class GeneralizedGaussianDiffusion(GaussianDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        eta: float = 0.0,
        ddim_timesteps: int = -1,
        class_conditional: bool = False,
        zero_terminal_snr: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(
            timesteps, schedule_name, schedule_cfg, objective,
            class_conditional, zero_terminal_snr, device,
        )
        if not (0.0 <= eta <= 1.0):
            raise ValueError("`eta` must be a value in [0, 1]. 0 = DDIM and 1 = DDPM mode")
        self.eta = float(eta)
        self.ddim_timesteps = int(ddim_timesteps) if ddim_timesteps > 0 else self.timesteps

    def compute_constants(self, timesteps: int) -> None:
        super().compute_constants(timesteps)
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        self.alphas_extended_cumprod = torch.cat([one, self.constants.alphas_cumprod])
        self._device_tables: Dict[str, torch.Tensor] = {}  # table_loop's tables, held by their graphs

    def table_tensors(self):
        return (*super().table_tensors(), self.alphas_extended_cumprod)

    def generalized_predict_start_from_noise(self, x_t, t, noise):
        acp = extract(self.alphas_extended_cumprod, t + 1, x_t.ndim)
        return (x_t - noise * torch.sqrt(1.0 - acp)) / torch.sqrt(acp)

    def generalized_predict_start_from_v(self, x_t, t, v):
        acp = extract(self.alphas_extended_cumprod, t + 1, x_t.ndim)
        return torch.sqrt(acp) * x_t - torch.sqrt(1.0 - acp) * v

    def p_mean_variance(self, model_fn, params, x, t, model_output=None) -> PMeanVariance:
        if model_output is None:
            model_output = model_fn(params, x, batched_t(t, x))
        if self.objective == "pred_noise":
            x_recon = self.generalized_predict_start_from_noise(x, t, model_output)
        elif self.objective == "pred_v":
            x_recon = self.generalized_predict_start_from_v(x, t, model_output)
        else:
            x_recon = model_output
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_variance = self.q_posterior(x_recon, x, t)
        return PMeanVariance(mean, None, log_variance, x_recon)

    def ddim_step(self, model_fn, params, x, t, t_next, generator=None, noise=None):
        """One generalized step x_t → x_{t_next}; returns (x_next, x̂₀).
        ``t``, ``t_next``: Python ints or 0-d tensors (a row of the chain's
        device table, eager or captured); at eta > 0 the noise is ``noise`` if given, else
        drawn from ``generator``."""
        model_output = model_fn(params, x, batched_t(t, x))
        if model_output.shape != x.shape:
            raise ValueError(
                f"DDIM needs a network output of x's shape {list(x.shape)}, got {list(model_output.shape)}: "
                "a learned-variance network (2C output channels) samples with its own ancestral sampler"
            )
        x0_t = self.p_mean_variance(model_fn, params, x, t, model_output=model_output).pred_x_start
        acp = extract(self.alphas_extended_cumprod, t + 1, x.ndim)
        acp_next = extract(self.alphas_extended_cumprod, t_next + 1, x.ndim)
        c1 = self.eta * torch.sqrt((1.0 - acp / acp_next) * (1.0 - acp_next) / (1.0 - acp))
        c2 = torch.sqrt((1.0 - acp_next) - c1**2)
        if self.objective == "pred_v":
            eps_hat = torch.sqrt(1.0 - acp) * x + torch.sqrt(acp) * model_output
        else:
            eps_hat = model_output
        x_next = torch.sqrt(acp_next) * x0_t + c2 * eps_hat
        if self.eta > 0.0:
            x_next = x_next + c1 * (noise if noise is not None else _randn(x.shape, generator, x.device))
        return x_next, x0_t

    def _strided_sequences(self) -> Tuple[np.ndarray, np.ndarray]:
        """Descending (t, t_next) pairs."""
        stride = self.timesteps // self.ddim_timesteps
        if stride < 1:
            raise ValueError(
                f"ddim_timesteps={self.ddim_timesteps} exceeds the model's "
                f"{self.timesteps}-step training schedule; choose "
                f"ddim_timesteps <= timesteps"
            )
        sequence = list(range(0, self.timesteps, stride))
        sequence_next = [-1] + sequence[:-1]
        return (
            np.asarray(sequence[::-1], dtype=np.int32),
            np.asarray(sequence_next[::-1], dtype=np.int32),
        )

    def _ddim_table(self) -> Dict[str, np.ndarray]:
        """The chain's (t, t_next) pairs as the columns of its device table."""
        seq, seq_next = self._strided_sequences()
        return {"t": seq, "t_next": seq_next}

    def p_sample_loop(
        self,
        model_fn: ModelFn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        img: Optional[torch.Tensor] = None,
        num_steps: Optional[int] = None,
        unnormalize: bool = True,
        graphs: Optional[bool] = None,
        return_frames: bool = False,
    ):
        """The strided chain from ``img`` (default N(0, I) from
        ``generator``). ``graphs``: replay a captured step (default: on
        CUDA) or run the Python loop; both draw the same numbers from
        ``generator`` in the same order. ``return_frames``: also the
        trajectory [M, B, H, W, C] in [0, 1], as ``(out, frames)``."""
        del num_steps  # the DDIM stride is set by ddim_timesteps
        table = device_table(self, "ddim", self._ddim_table, ("t", "t_next"), dtype=np.int64)
        M = int(table.shape[0])
        x = img if img is not None else _randn(shape, generator, self.device)
        frames = new_frames(M, x) if return_frames else None
        noisy = self.eta > 0.0

        def step(fn, s, row):
            t, t_next = row.unbind(0)
            s["x"].copy_(self.ddim_step(fn, params, s["x"], t, t_next, noise=s.get("noise"))[0])

        def draw(s, i):
            s["noise"].normal_(generator=generator)

        state = {"x": x.clone(), **({"noise": torch.empty_like(x)} if noisy else {})}
        state = table_loop(self, "ddim", model_fn, params, state, table, step, M,
                           graphs_lib.use_graphs(graphs, x.device), draw=draw if noisy else None,
                           frame=lambda s, row: s["x"], frames=frames)
        x = state["x"]
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()  # not the graph's own buffer
        return (out, frames) if return_frames else out

    def interpolate(self, model_fn, params, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, t: Optional[int] = None, lambd: float = 0.5,
                    return_frames: bool = False, graphs: Optional[bool] = None):
        """DDIM interpolation: the strided chain from the given latent
        ``x1`` (the caller slerps the latents; ``x2``, ``t`` and ``lambd``
        are unused, as in the JAX package)."""
        return self.p_sample_loop(model_fn, params, tuple(x1.shape), generator, img=x1, graphs=graphs,
                                  return_frames=return_frames)
