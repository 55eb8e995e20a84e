"""DPM-Solver++ (Lu et al. 2022), order 1 or 2, multistep, data prediction.

Counterpart of ``diffusion_model_nemo_tpu/modules/dpm_solver.py``: the same
step grid (``strided``, DDIM's, or ``logsnr``, the discrete times nearest a
uniform log-SNR grid, ``np.unique``'d, so M may come out under
``solver_steps``), the same host coefficient table in float64 numpy cast
once to float32, and the same update

    x_t = (σ_t/σ_s)·x_s + (α_t − α_s·σ_t/σ_s)·D,   D = (1 − w)·x̂₀ + w·x̂₀_prev,

with w = 0 on the order-1 steps (the first, the data endpoint, the last
under ``lower_order_final``). The network is conditioned on the float32
grid times, as the JAX scan's ``batched_t`` passes them. On CUDA the chain
is replays of one captured step (``table_loop``), x̂₀_prev a static buffer
zeroed before each chain. A learned-variance output ([B, H, W, 2C]) raises
``ValueError``: the JAX loop's reshape fails there (``TypeError``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .gaussian_diffusion import _randn, batched_t, new_frames
from .generalized_gaussian_diffusion import GeneralizedGaussianDiffusion
from .table_loop import device_table, table_loop

__all__ = ["DPMSolverDiffusion", "network_output"]

DPM_COLUMNS = ("t", "alpha_s", "sigma_s", "c_x", "c_d", "w_prev")


def network_output(model_fn, params, x: torch.Tensor, t: torch.Tensor, sampler: str) -> torch.Tensor:
    """The network at the float32 time ``t`` (0-d, passed on as float32
    [B]), refusing an output that is not x's shape (a learned variance, 2C
    channels)."""
    out = model_fn(params, x, batched_t(t, x))
    if out.shape != x.shape:
        raise ValueError(
            f"{sampler} needs a network output of x's shape {list(x.shape)}, got {list(out.shape)}: a "
            "learned-variance network (2C output channels) samples with its own ancestral sampler"
        )
    return out


@register_target(
    "diffusion_model_nemo.modules.DPMSolverDiffusion",
    "diffusion_model_nemo_tpu.modules.DPMSolverDiffusion",
)
class DPMSolverDiffusion(GeneralizedGaussianDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        solver_steps: int = 20,
        solver_order: int = 2,
        lower_order_final: bool = True,
        clip_denoised: bool = True,
        time_spacing: str = "strided",
        class_conditional: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(
            timesteps, schedule_name, schedule_cfg, objective, eta=0.0, ddim_timesteps=solver_steps,
            class_conditional=class_conditional, device=device,
        )
        if solver_order not in (1, 2):
            raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
        if time_spacing not in ("strided", "logsnr"):
            raise ValueError(f"time_spacing must be strided|logsnr, got {time_spacing}")
        self.solver_steps = int(solver_steps)
        self.solver_order = int(solver_order)
        self.lower_order_final = bool(lower_order_final)
        self.clip_denoised = bool(clip_denoised)
        self.time_spacing = time_spacing

    def _alphas_cumprod_host(self) -> np.ndarray:
        return self.constants.alphas_cumprod.cpu().numpy().astype(np.float64)

    def _alphas_extended_host(self) -> np.ndarray:
        return self.alphas_extended_cumprod.cpu().numpy().astype(np.float64)

    # ---- step grid -----------------------------------------------------------
    def _solver_sequences(self) -> Tuple[np.ndarray, np.ndarray]:
        """Descending (t, t_next) index pairs ending at −1 (ᾱ = 1)."""
        if self.time_spacing == "strided":
            return self._strided_sequences()
        acp = self._alphas_cumprod_host()
        lam = 0.5 * (np.log(acp) - np.log1p(-acp))  # log(alpha/sigma)
        targets = np.linspace(lam[self.timesteps - 1], lam[0], self.solver_steps)
        idx = np.unique(np.abs(lam[None, :] - targets[:, None]).argmin(axis=1))
        seq = np.sort(idx)[::-1].astype(np.int32)  # descending t
        seq_next = np.concatenate([seq[1:], np.asarray([-1], np.int32)])
        return seq, seq_next

    def _solver_coefficients(self) -> Dict[str, np.ndarray]:
        """The per-step scalars, [M] float32 each (the JAX package's host
        code): t, alpha_s, sigma_s, c_x = σ_t/σ_s, c_d = α_t − α_s·σ_t/σ_s,
        w_prev (0 on order-1 steps)."""
        seq, seq_next = self._solver_sequences()
        acp_ext = self._alphas_extended_host()
        a_s = np.sqrt(acp_ext[seq + 1])
        s_s = np.sqrt(1.0 - acp_ext[seq + 1])
        a_t = np.sqrt(acp_ext[seq_next + 1])
        s_t = np.sqrt(1.0 - acp_ext[seq_next + 1])

        c_x = s_t / s_s
        c_d = a_t - a_s * s_t / s_s

        M = len(seq)
        w_prev = np.zeros(M)
        if self.solver_order == 2:
            with np.errstate(divide="ignore"):
                lam_s = np.log(a_s) - np.log(s_s)
                lam_t = np.where(s_t > 0.0, np.log(a_t) - np.log(np.maximum(s_t, 1e-300)), np.inf)
            h = lam_t - lam_s  # [M], h[i] spans step i
            for i in range(1, M):
                if not np.isfinite(h[i]):  # data endpoint: order-1 is exact
                    continue
                if self.lower_order_final and i == M - 1:
                    continue
                w_prev[i] = -h[i] / (2.0 * h[i - 1])
        return {
            "t": seq.astype(np.float32),
            "alpha_s": a_s.astype(np.float32),
            "sigma_s": s_s.astype(np.float32),
            "c_x": c_x.astype(np.float32),
            "c_d": c_d.astype(np.float32),
            "w_prev": w_prev.astype(np.float32),
        }

    def _x0(self, raw: torch.Tensor, x: torch.Tensor, alpha_s, sigma_s) -> torch.Tensor:
        """x̂₀ from the network's output at (α_s, σ_s), clipped."""
        if self.objective == "pred_noise":
            x0 = (x - sigma_s * raw) / alpha_s
        elif self.objective == "pred_v":
            x0 = alpha_s * x - sigma_s * raw
        else:
            x0 = raw
        return x0.clamp(-1.0, 1.0) if self.clip_denoised else x0

    # ---- sampling ------------------------------------------------------------
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
        """The solver's chain from ``img`` (default N(0, I) from
        ``generator``, the only draw); ``graphs`` and ``return_frames`` as
        in ``GeneralizedGaussianDiffusion.p_sample_loop`` (frames [M, B, H,
        W, C])."""
        del num_steps  # the grid is set by solver_steps / time_spacing
        table = device_table(self, "dpm_solver", self._solver_coefficients, DPM_COLUMNS)
        M = int(table.shape[0])
        x = img if img is not None else _randn(shape, generator, self.device)
        frames = new_frames(M, x) if return_frames else None

        def step(fn, s, row):
            t, alpha_s, sigma_s, c_x, c_d, w_prev = row.unbind(0)
            x0 = self._x0(network_output(fn, params, s["x"], t, "DPM-Solver++"), s["x"], alpha_s, sigma_s)
            d = (1.0 - w_prev) * x0 + w_prev * s["x0_prev"]
            s["x"].copy_(c_x * s["x"] + c_d * d)
            s["x0_prev"].copy_(x0)

        state = {"x": x.clone(), "x0_prev": torch.zeros_like(x)}
        state = table_loop(self, "dpm_solver", model_fn, params, state, table, step, M,
                           graphs_lib.use_graphs(graphs, x.device), frame=lambda s, row: s["x"], frames=frames)
        x = state["x"]
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out
