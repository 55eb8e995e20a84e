"""Generalized (DDIM) sampler, Song et al. 2020, eq. 12.

Counterpart of
``diffusion_model_nemo_tpu/modules/generalized_gaussian_diffusion.py``:
``eta`` in [0, 1] (0 = DDIM), ``ddim_timesteps`` strided subsampling, and
the ᾱ table extended with a leading 1.0 so that t = −1 maps to ᾱ = 1
(indexed at t + 1). With ``eta = 0`` the noise term is exactly zero and no
noise is drawn. The JAX package's chain is one ``lax.scan``; here, on CUDA,
it is replays of one captured ``ddim_step`` (``ops/graphs.py``) that reads
(t, t_next) from device tables at a device step counter, with x_T and any
noise drawn eagerly, in the eager loop's order, into static buffers.

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
from .gaussian_diffusion import (
    GaussianDiffusion, PMeanVariance, _randn, batched_t, fill_static, graph_key, static_model_fn,
)

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
        ``t``, ``t_next``: Python ints (the eager loop) or 0-d device tensors
        (the captured step); at eta > 0 the noise is ``noise`` if given, else
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
    ) -> torch.Tensor:
        """The strided chain from ``img`` (default N(0, I) from
        ``generator``). ``graphs``: replay a captured step (default: on
        CUDA) or run the Python loop; both draw the same numbers from
        ``generator`` in the same order."""
        del num_steps  # the DDIM stride is set by ddim_timesteps
        seq, seq_next = self._strided_sequences()
        x = img if img is not None else _randn(shape, generator, self.device)
        if graphs_lib.use_graphs(graphs, x.device):
            x = self._ddim_replays(model_fn, params, x, seq, seq_next, generator)
            x = x if unnormalize else x.clone()  # not the graph's own buffer
        else:
            for t, t_next in zip(seq, seq_next):
                x, _ = self.ddim_step(model_fn, params, x, int(t), int(t_next), generator)
        return (x + 1.0) * 0.5 if unnormalize else x

    def _ddim_replays(self, model_fn, params, x, seq, seq_next, generator) -> torch.Tensor:
        """The chain as replays of one captured step that gathers (t,
        t_next) from device tables at a 0-d step counter and advances it; at
        eta > 0 the step's noise is drawn into a static buffer before each
        replay. The first step runs eagerly (the capture's warm-up). Returns
        the static x."""
        noisy = self.eta > 0.0
        static = None

        def draw():
            if noisy:
                static["noise"].normal_(generator=generator)

        def build():
            nonlocal static
            dev = x.device
            static = {
                "x": x.clone(), "i": torch.zeros((), dtype=torch.long, device=dev),
                "seq": torch.as_tensor(seq, dtype=torch.long).to(dev),
                "seq_next": torch.as_tensor(seq_next, dtype=torch.long).to(dev),
                "noise": torch.empty_like(x) if noisy else None,
                "alphas": self.alphas_extended_cumprod, "constants": self.constants,
            }
            fn = static_model_fn(model_fn, static)

            def step():
                i = static["i"].reshape(1)
                t, t_next = static["seq"].gather(0, i)[0], static["seq_next"].gather(0, i)[0]
                static["x"].copy_(self.ddim_step(fn, params, static["x"], t, t_next, noise=static["noise"])[0])
                static["i"].add_(1)

            def warmup():  # the chain's first step
                draw()
                step()

            return graphs_lib.Graph("ddim", step, static, device=dev, warmup=warmup)

        key = ("ddim", tuple(int(t) for t in seq), tuple(x.shape), x.dtype, x.device, *graph_key(model_fn))
        graph, built = graphs_lib.cached(self.graphs, key, (params or {}).values(), build)
        static = graph.static
        if not built:
            static["x"].copy_(x)
            static["i"].zero_()
            fill_static(model_fn, static)
        for _ in range(len(seq) - built):
            draw()
            graph.replay()
        return static["x"]
