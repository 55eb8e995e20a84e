"""Consistency-model sampler (Song et al. 2023): one-to-few-step generation
from a consistency-distilled student (``training/consistency.py``).

Counterpart of ``diffusion_model_nemo_tpu/modules/consistency_sampler.py``.
The network is read through the consistency head

    f(x̂, σ) = c_skip(σ)·x̂ + c_out(σ)·F(a·x̂, t(σ)),
    c_skip = σ_d² / ((σ − σ_min)² + σ_d²),  c_out = σ_d·(σ − σ_min) / √(σ_d² + σ²),

so f(x̂, σ_min) = x̂ exactly. Coordinates are the Karras sampler's
(``karras_diffusion.py``): x̂ = x_t/a, the network at a·x̂ = x̂/√(1 + σ²)
and the float time of the log-σ interpolation, off the integer grid.

Multistep sampling (Algorithm 1): f at σ_max, then for each further level
σ_k a re-noise x₀ + √(σ_k² − σ_min²)·z and f again; NFE = ``sample_steps``.
The levels are one device table [K, 3] (σ, t, re-noise std; the first
level's std is 0 and its noise buffer zero), so on CUDA the chain is replays
of one captured step (``table_loop``), equal to its eager loop bit for bit.
The initial image and the K − 1 re-noise draws come from the generator, or
are injected (``img``, ``noise`` [K − 1, *shape]) as the tests feed JAX's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .gaussian_diffusion import _randn, batched_t, new_frames
from .karras_diffusion import KarrasDiffusion
from .table_loop import device_table, table_loop

__all__ = ["ConsistencySampler"]

LEVEL_COLUMNS = ("sigma", "t", "level")


@register_target(
    "diffusion_model_nemo.modules.ConsistencySampler",
    "diffusion_model_nemo_tpu.modules.ConsistencySampler",
)
class ConsistencySampler(KarrasDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        sample_steps: int = 1,
        sigma_data: float = 0.5,
        rho: float = 7.0,
        sigma_min: Optional[float] = None,
        sigma_max: Optional[float] = None,
        clip_denoised: bool = True,
        class_conditional: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        # solver_steps seeds the parent's grid helpers only; the levels are
        # _consistency_sigmas'.
        super().__init__(
            timesteps=timesteps, schedule_name=schedule_name, schedule_cfg=schedule_cfg, objective=objective,
            solver_steps=max(int(sample_steps) + 1, 2), solver_order=1, grid="karras", rho=rho,
            sigma_min=sigma_min, sigma_max=sigma_max, clip_denoised=clip_denoised,
            class_conditional=class_conditional, device=device,
        )
        if sample_steps < 1:
            raise ValueError(f"sample_steps must be >= 1, got {sample_steps}")
        self.sample_steps = int(sample_steps)
        self.sigma_data = float(sigma_data)
        self._sigma_floor()

    def compute_constants(self, timesteps: int) -> None:
        super().compute_constants(timesteps)
        self._levels: Optional[Tuple[np.ndarray, np.ndarray, float]] = None

    # ---- head ------------------------------------------------------------------
    def _host_levels(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(the K = ``sample_steps`` descending evaluation σ, σ_max first and
        σ_min excluded; their conditioning times; σ_min, the boundary
        level), made from the schedule once and kept on the host from its
        ``compute_constants`` on: every chain reads σ_max for its initial
        image and a captured step reads σ_min, and reading the schedule's
        device table would sync the host each call (a capture forbids it)."""
        if self._levels is None:
            sig, t_cond = self._sigma_grid()  # [K + 2]: σ_min and 0 at the end
            self._levels = (sig[: self.sample_steps], t_cond[: self.sample_steps], float(sig[-2]))
        return self._levels

    def _consistency_sigmas(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._host_levels()[:2]

    def _sigma_floor(self) -> float:
        return self._host_levels()[2]

    def _level_table(self) -> Dict[str, np.ndarray]:
        sig, t_cond = self._consistency_sigmas()
        smin = self._sigma_floor()
        level = np.sqrt(np.maximum(sig**2 - smin**2, 0.0))
        level[0] = 0.0  # the first evaluation is of the initial image itself
        return {"sigma": sig, "t": t_cond, "level": level}

    def consistency_fn(self, model_fn: ModelFn, params: Any, xhat: torch.Tensor, sigma, t) -> torch.Tensor:
        """f(x̂, σ) over the raw network. ``sigma`` / ``t``: Python or 0-d
        scalars (sampling) or [B, 1, 1, 1] / [B] per-sample levels (the
        distiller's); the coefficients are float32, as JAX's."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=xhat.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=xhat.device)
        smin, sd = self._sigma_floor(), self.sigma_data
        c_skip = sd**2 / ((sigma - smin) ** 2 + sd**2)
        c_out = sd * (sigma - smin) / torch.sqrt(sd**2 + sigma * sigma)
        a = 1.0 / torch.sqrt(1.0 + sigma * sigma)  # the VP input scale
        x_net = a * xhat
        out = model_fn(params, x_net, batched_t(t, x_net))
        if out.shape[-1] != x_net.shape[-1]:  # a learned variance: the first half
            out = out[..., : x_net.shape[-1]]
        f = c_skip * xhat + c_out * out
        return f.clamp(-1.0, 1.0) if self.clip_denoised else f

    # ---- sampling ----------------------------------------------------------------
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
        noise: Optional[torch.Tensor] = None,
    ):
        """The K-evaluation chain from ``img`` (default N(0, σ_max²) from
        ``generator``), the re-noise draws after it from ``generator`` (or
        ``noise[k − 1]``). ``num_steps`` is ignored (the level count is
        ``sample_steps``). Returns [B, H, W, C] in [0, 1] (``unnormalize``),
        and under ``return_frames`` each level's x̂₀ in [0, 1], [K, *shape]."""
        del num_steps
        K = self.sample_steps
        table = device_table(self, "consistency", self._level_table, LEVEL_COLUMNS)
        if img is None:
            img = _randn(tuple(shape), generator, self.device) * float(self._consistency_sigmas()[0][0])
        x = img.to(device=self.device, dtype=torch.float32).reshape(shape)
        if noise is not None and tuple(noise.shape) != (K - 1, *x.shape):
            raise ValueError(f"noise must be [K - 1, *shape] = {[K - 1, *x.shape]}, got {list(noise.shape)}")
        frames = new_frames(K, x) if return_frames else None

        def draw(s, i):
            if i == 0:
                s["noise"].zero_()
            elif noise is not None:
                s["noise"].copy_(noise[i - 1])
            else:
                s["noise"].normal_(generator=generator)

        def step(fn, s, row):
            sigma, t, level = row.unbind(0)
            x_in = s["x"] + level * s["noise"] if "noise" in s else s["x"]
            s["x"].copy_(self.consistency_fn(fn, params, x_in, sigma, t))

        state = {"x": x.clone()}
        if K > 1:
            state["noise"] = torch.empty_like(x)
        state = table_loop(self, "consistency", model_fn, params, state, table, step, K,
                           graphs_lib.use_graphs(graphs, x.device), draw=draw if K > 1 else None,
                           frame=lambda s, row: s["x"], frames=frames)
        x = state["x"]
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out
