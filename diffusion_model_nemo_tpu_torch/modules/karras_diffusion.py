"""The EDM / Karras sampler (Karras et al. 2022, Algorithm 2) on a
discrete-time VP model: Euler or Heun steps on a ``karras`` ρ-spaced or
``ddim`` σ grid, with optional churn.

Counterpart of ``diffusion_model_nemo_tpu/modules/karras_diffusion.py``:
x̂ = x_t/a, σ̂ = s/a, the network evaluated at a·x̂ and conditioned on the
float time ``np.interp(log σ̂, λ, arange(T))`` (off the integer grid: the
time reaches the network as float32 [B], ``batched_t`` keeps the float),
the same host table (float64 numpy cast once to float32), order 2 as M − 1
Heun steps (two forwards each) and one Euler step to σ = 0 after them, a
graph of its own (NFE 2M − 1), order 1 as M Euler steps (on the ``ddim`` grid exactly DDIM
η = 0), the prior N(0, σ_max²). Churn noise is drawn into a static buffer
before each step, in the eager loop's order (``s_churn = 0`` draws
nothing); ``noise`` [M, *shape] injects it (the tests feed the JAX scan's
draws). On CUDA the steps are replays of one captured step (``table_loop``).
A learned-variance output raises
``ValueError`` (the JAX loop's reshape fails there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .dpm_solver import network_output
from .gaussian_diffusion import _randn, new_frames
from .generalized_gaussian_diffusion import GeneralizedGaussianDiffusion
from .table_loop import device_table, table_loop

__all__ = ["KarrasDiffusion"]

KARRAS_COLUMNS = ("sigma_hat", "noise_std", "t_hat", "a_hat", "sigma_next", "t_next", "a_next", "dt")


@register_target(
    "diffusion_model_nemo.modules.KarrasDiffusion",
    "diffusion_model_nemo_tpu.modules.KarrasDiffusion",
)
class KarrasDiffusion(GeneralizedGaussianDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        solver_steps: int = 18,
        solver_order: int = 2,
        grid: str = "karras",
        rho: float = 7.0,
        sigma_min: Optional[float] = None,
        sigma_max: Optional[float] = None,
        s_churn: float = 0.0,
        s_noise: float = 1.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        clip_denoised: bool = True,
        class_conditional: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(
            timesteps, schedule_name, schedule_cfg, objective, eta=0.0, ddim_timesteps=solver_steps,
            class_conditional=class_conditional, device=device,
        )
        if solver_order not in (1, 2):
            raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
        if grid not in ("karras", "ddim"):
            raise ValueError(f"grid must be karras|ddim, got {grid}")
        if solver_steps < 2:
            raise ValueError(f"solver_steps must be >= 2, got {solver_steps}")
        self.solver_steps = int(solver_steps)
        self.solver_order = int(solver_order)
        self.grid = grid
        self.rho = float(rho)
        self.sigma_min = None if sigma_min is None else float(sigma_min)
        self.sigma_max = None if sigma_max is None else float(sigma_max)
        self.s_churn = float(s_churn)
        self.s_noise = float(s_noise)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.clip_denoised = bool(clip_denoised)

    # ---- σ grid / conditioning tables -------------------------------------------
    def _log_sigma_table(self) -> np.ndarray:
        """[T] log σ̂ at the discrete steps, increasing in t."""
        acp = self.constants.alphas_cumprod.cpu().numpy().astype(np.float64)
        return 0.5 * (np.log1p(-acp) - np.log(acp))  # log(s/a)

    def _sigma_grid(self) -> Tuple[np.ndarray, np.ndarray]:
        """The descending σ̂ grid [M+1] (last entry 0) and the conditioning
        times [M+1]: ``karras`` (eq. 5, endpoints the schedule's own by
        default, times by log-σ interpolation) or ``ddim`` (the strided
        grid's exact σ̂ and integer times)."""
        lam = self._log_sigma_table()
        if self.grid == "ddim":
            seq, _ = self._strided_sequences()  # descending ints
            sig = np.exp(lam[seq])
            t_cond = seq.astype(np.float64)
        else:
            smin = self.sigma_min if self.sigma_min is not None else float(np.exp(lam[0]))
            smax = self.sigma_max if self.sigma_max is not None else float(np.exp(lam[-1]))
            if not (0.0 < smin < smax):
                raise ValueError(f"need 0 < sigma_min < sigma_max, got {smin}, {smax}")
            N = self.solver_steps
            inv_rho = 1.0 / self.rho
            ramp = np.linspace(0.0, 1.0, N)
            sig = (smax**inv_rho + ramp * (smin**inv_rho - smax**inv_rho)) ** self.rho
            t_cond = np.interp(np.log(sig), lam, np.arange(self.timesteps, dtype=np.float64))
        sig = np.concatenate([sig, [0.0]])
        t_cond = np.concatenate([t_cond, [0.0]])  # unused at sigma = 0
        return sig, t_cond

    def _solver_coefficients(self) -> Dict[str, np.ndarray]:
        """Per transition i (σ_i → σ_{i+1}), [M] float32 each: sigma_hat
        (churn-inflated start), noise_std, t_hat / a_hat (conditioning time
        and input scale at σ̂), sigma_next, t_next / a_next (Heun's second
        evaluation), dt = σ_{i+1} − σ̂."""
        sig, t_cond = self._sigma_grid()
        lam = self._log_sigma_table()
        M = len(sig) - 1

        gamma = np.zeros(M)
        if self.s_churn > 0.0:
            g = min(self.s_churn / M, np.sqrt(2.0) - 1.0)
            in_window = (sig[:M] >= self.s_tmin) & (sig[:M] <= self.s_tmax)
            gamma = np.where(in_window, g, 0.0)
        sigma_hat = sig[:M] * (1.0 + gamma)
        noise_std = self.s_noise * np.sqrt(np.maximum(sigma_hat**2 - sig[:M] ** 2, 0.0))
        t_hat = np.where(
            gamma > 0.0,
            np.interp(np.log(np.maximum(sigma_hat, 1e-300)), lam, np.arange(self.timesteps, dtype=np.float64)),
            t_cond[:M],
        )
        a_hat = 1.0 / np.sqrt(1.0 + sigma_hat**2)
        a_next = 1.0 / np.sqrt(1.0 + sig[1:] ** 2)
        f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
        return {
            "sigma_hat": f32(sigma_hat), "noise_std": f32(noise_std), "t_hat": f32(t_hat), "a_hat": f32(a_hat),
            "sigma_next": f32(sig[1:]), "t_next": f32(t_cond[1:]), "a_next": f32(a_next),
            "dt": f32(sig[1:] - sigma_hat),
        }

    # ---- the network in EDM coordinates -------------------------------------------
    def _denoise(self, model_fn, params, xhat, t, a, sigma) -> torch.Tensor:
        """x̂₀ at (x̂, σ̂): the network runs in model (VP) space at a·x̂ and
        the float32 time ``t``."""
        out = network_output(model_fn, params, a * xhat, t, "the Karras sampler")
        if self.objective == "pred_noise":
            x0 = xhat - sigma * out
        elif self.objective == "pred_v":
            x0 = a * (a * xhat - sigma * out)
        else:  # pred_x0
            x0 = out
        return x0.clamp(-1.0, 1.0) if self.clip_denoised else x0

    def _slope(self, fn, params, x, t, a, sigma) -> torch.Tensor:
        """The ODE slope (x̂ − x̂₀)/σ̂."""
        return (x - self._denoise(fn, params, x, t, a, sigma)) / sigma.clamp_min(1e-12)

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
        """The chain from ``img`` (default N(0, σ_max²) from ``generator``),
        then the churn draws, one a step (or ``noise[i]``). ``graphs`` and
        ``return_frames`` (frames [M, B, H, W, C] in data space) as in
        ``GeneralizedGaussianDiffusion.p_sample_loop``."""
        del num_steps  # the grid is set by solver_steps / grid / rho
        table = device_table(self, "karras", self._solver_coefficients, KARRAS_COLUMNS)
        M = int(table.shape[0])
        if img is None:
            sig_grid, _ = self._sigma_grid()
            img = _randn(shape, generator, self.device) * float(sig_grid[0])
        x = img
        stochastic = self.s_churn > 0.0
        if noise is not None and tuple(noise.shape) != (M, *x.shape):
            raise ValueError(f"noise must be [M, *shape] = {[M, *x.shape]}, got {list(noise.shape)}")
        frames = new_frames(M, x) if return_frames else None

        def draw(s, i):
            if noise is not None:
                s["noise"].copy_(noise[i])
            else:
                s["noise"].normal_(generator=generator)

        def euler_half(fn, s, row):
            """Churn, then the slope at σ̂: (x, x_e = x + dt·d, d)."""
            sigma_hat, noise_std, t_hat, a_hat, _sn, _tn, _an, dt = row.unbind(0)
            x = s["x"]
            if stochastic:
                x = x + noise_std * s["noise"]
            d = self._slope(fn, params, x, t_hat, a_hat, sigma_hat)
            return x, x + dt * d, d

        def heun(fn, s, row):
            x, x_e, d = euler_half(fn, s, row)
            _sh, _ns, _th, _ah, sigma_next, t_next, a_next, dt = row.unbind(0)
            d2 = self._slope(fn, params, x_e, t_next, a_next, sigma_next)
            s["x"].copy_(x + dt * 0.5 * (d + d2))

        def euler(fn, s, row):
            s["x"].copy_(euler_half(fn, s, row)[1])

        state = {"x": x.clone()}
        if stochastic:
            state["noise"] = torch.empty_like(x)
        use = graphs_lib.use_graphs(graphs, x.device)
        frame = lambda s, row: row[6] * s["x"]  # noqa: E731  (frames in data space: a·x̂)
        if self.solver_order == 1:
            state = table_loop(self, "karras_euler", model_fn, params, state, table, euler, M, use,
                               draw=draw if stochastic else None, frame=frame, frames=frames)
        else:  # M − 1 Heun steps, then the Euler step to σ = 0, captured apart
            state = table_loop(self, "karras_heun", model_fn, params, state, table, heun, M - 1, use,
                               draw=draw if stochastic else None, frame=frame, frames=frames)
            last = device_table(self, "karras_last", self._solver_coefficients, KARRAS_COLUMNS,
                                rows=slice(M - 1, M))
            state = table_loop(self, "karras_last", model_fn, params,
                               {k: v for k, v in state.items() if k in ("x", "noise")}, last, euler, 1, use,
                               draw=(lambda s, i: draw(s, M - 1)) if stochastic else None, frame=frame,
                               frames=None if frames is None else frames[M - 1:])
        x = state["x"]
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out
