"""UniPC (Zhao et al. 2023): a multistep predictor (UniP) with an optional
corrector (UniC) at no extra network call, orders 1-3, ``bh1`` / ``bh2``.

Counterpart of ``diffusion_model_nemo_tpu/modules/unipc.py``: the same
grid as DPM-Solver++ (``strided`` / ``logsnr``), the same host table (the
φ-functions and the solved R·ρ = b weights, float64 numpy cast once to
float32) and the same step: the corrector refines the sample the network
was just evaluated at (the evaluation stays at the uncorrected point),
gated per step by ``g``, then the predictor steps to the next grid time.
The multistep memory (the running sample, the previous corrected sample
and a 3-deep ring of x̂₀ predictions) is static buffers zeroed before each
chain (``table_loop``). Exact relations the tests hold: order 1 without the
corrector is DDIM η = 0; order 2 ``bh2`` without it is DPM-Solver++(2M);
every order is exact on a constant-x̂₀ field. A learned-variance output
raises ``ValueError`` (the JAX loop's reshape fails there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .dpm_solver import DPMSolverDiffusion, network_output
from .gaussian_diffusion import _randn, new_frames
from .table_loop import device_table, table_loop

__all__ = ["UniPCDiffusion"]

UNIPC_COLUMNS = ("t", "alpha_s", "sigma_s", "p_cx", "p_cm", "pw0", "pw1", "c_cx", "c_cm", "cw0", "cw1", "cwt", "g")


@register_target(
    "diffusion_model_nemo.modules.UniPCDiffusion",
    "diffusion_model_nemo_tpu.modules.UniPCDiffusion",
)
class UniPCDiffusion(DPMSolverDiffusion):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        solver_steps: int = 20,
        solver_order: int = 2,
        variant: str = "bh2",
        use_corrector: bool = True,
        lower_order_final: bool = True,
        clip_denoised: bool = True,
        time_spacing: str = "strided",
        class_conditional: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(
            timesteps, schedule_name, schedule_cfg, objective, solver_steps=solver_steps,
            solver_order=1,  # placeholder; UniPC validates its own order below
            lower_order_final=lower_order_final, clip_denoised=clip_denoised, time_spacing=time_spacing,
            class_conditional=class_conditional, device=device,
        )
        if solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order must be 1, 2 or 3, got {solver_order}")
        if variant not in ("bh1", "bh2"):
            raise ValueError(f"variant must be bh1|bh2, got {variant}")
        self.solver_order = int(solver_order)
        self.variant = variant
        self.use_corrector = bool(use_corrector)

    # ---- host-side coefficient tables -----------------------------------------
    def _phis(self, hh: float, order: int) -> Tuple[float, float, np.ndarray]:
        """φ₁ = expm1(hh), B(h), and the b vector of the UniPC system
        (eq. 16/17): b_k = φ_{k+1}(hh)·k!/B(h)."""
        h_phi_1 = np.expm1(hh)
        B_h = hh if self.variant == "bh1" else np.expm1(hh)
        b = []
        h_phi_k = h_phi_1 / hh - 1.0
        fact = 1.0
        for row in range(1, order + 1):
            b.append(h_phi_k * fact / B_h)
            fact *= row + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        return h_phi_1, B_h, np.asarray(b, np.float64)

    def _unipc_coefficients(self) -> Dict[str, np.ndarray]:
        """The per-step scalars, [M] float32 each (the JAX package's host
        code). Predictor (s0 = seq[i] → seq_next[i]):
        x_next = p_cx·x + p_cm·m0 + pw0·(m1 − m0) + pw1·(m2 − m0);
        corrector (gated by g): x_corr = c_cx·x_last + c_cm·m1 +
        cw0·(m2 − m1) + cw1·(m3 − m1) + cwt·(m0 − m1), m_k the x̂₀ at
        seq[i − k]."""
        seq, seq_next = self._solver_sequences()
        acp_ext = self._alphas_extended_host()
        M = len(seq)
        a_s = np.sqrt(acp_ext[seq + 1])
        s_s = np.sqrt(1.0 - acp_ext[seq + 1])
        a_t = np.sqrt(acp_ext[seq_next + 1])
        s_t = np.sqrt(1.0 - acp_ext[seq_next + 1])
        with np.errstate(divide="ignore"):
            lam = np.log(a_s) - np.log(s_s)
            lam_t = np.where(s_t > 0.0, np.log(a_t) - np.log(np.maximum(s_t, 1e-300)), np.inf)
        h = lam_t - lam  # [M]; h[i] spans predictor step i

        K = self.solver_order
        op = np.zeros(M, np.int64)  # predictor order per step (warm-up / warm-down)
        for i in range(M):
            o = min(K, i + 1)
            if self.lower_order_final:
                o = min(o, M - i)
            if not np.isfinite(h[i]):
                o = 1  # data endpoint: order-1 is exact
            op[i] = max(1, o)
        oc = np.zeros(M, np.int64)  # corrector order = previous predictor order
        if self.use_corrector:
            oc[1:] = op[:-1]

        z = lambda: np.zeros(M, np.float64)  # noqa: E731
        p_cx, p_cm, pw0, pw1 = s_t / s_s, z(), z(), z()
        c_cx, c_cm, cw0, cw1, cwt, g = z(), z(), z(), z(), z(), z()

        for i in range(M):
            # ---- UniP weights
            o = int(op[i])
            if np.isfinite(h[i]):
                h_phi_1, B_h, b = self._phis(-h[i], o)
                p_cm[i] = -a_t[i] * h_phi_1
                if o > 1:
                    rks = np.asarray([(lam[i - k] - lam[i]) / h[i] for k in range(1, o)] + [1.0])
                    if o == 2:
                        rhos = np.asarray([0.5])  # UniPC's fixed order-2 weight
                    else:
                        R = np.stack([np.power(rks, r) for r in range(o)])
                        rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
                    pw = [-a_t[i] * B_h * rhos[k - 1] / rks[k - 1] for k in range(1, o)]
                    pw0[i] = pw[0]
                    if o > 2:
                        pw1[i] = pw[1]
            else:
                p_cm[i] = a_t[i]  # -a_t·expm1(-inf): the final step lands on x0
            # ---- UniC weights (correct the step that arrived at s0)
            o = int(oc[i])
            if o > 0:
                hc = lam[i] - lam[i - 1]
                h_phi_1, B_h, b = self._phis(-hc, o)
                c_cx[i] = s_s[i] / s_s[i - 1]
                c_cm[i] = -a_s[i] * h_phi_1
                rks = np.asarray([(lam[i - 1 - k] - lam[i - 1]) / hc for k in range(1, o)] + [1.0])
                if o == 1:
                    rhos = np.asarray([0.5])  # trapezoidal correction
                else:
                    R = np.stack([np.power(rks, r) for r in range(o)])
                    rhos = np.linalg.solve(R, b)
                cw = [-a_s[i] * B_h * rhos[k - 1] / rks[k - 1] for k in range(1, o)]
                if o > 1:
                    cw0[i] = cw[0]
                if o > 2:
                    cw1[i] = cw[1]
                cwt[i] = -a_s[i] * B_h * rhos[-1]
                g[i] = 1.0

        f32 = lambda v: v.astype(np.float32)  # noqa: E731
        return {
            "t": f32(seq.astype(np.float64)), "alpha_s": f32(a_s), "sigma_s": f32(s_s),
            "p_cx": f32(p_cx), "p_cm": f32(p_cm), "pw0": f32(pw0), "pw1": f32(pw1),
            "c_cx": f32(c_cx), "c_cm": f32(c_cm), "cw0": f32(cw0), "cw1": f32(cw1), "cwt": f32(cwt), "g": f32(g),
        }

    # ---- sampling --------------------------------------------------------------
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
        """The UniPC chain from ``img`` (default N(0, I) from ``generator``,
        the only draw); ``graphs`` and ``return_frames`` as in
        ``DPMSolverDiffusion.p_sample_loop``."""
        del num_steps  # the grid is set by solver_steps / time_spacing
        table = device_table(self, "unipc", self._unipc_coefficients, UNIPC_COLUMNS)
        M = int(table.shape[0])
        x = img if img is not None else _randn(shape, generator, self.device)
        frames = new_frames(M, x) if return_frames else None

        def step(fn, s, row):
            t, alpha_s, sigma_s, p_cx, p_cm, pw0, pw1, c_cx, c_cm, cw0, cw1, cwt, g = row.unbind(0)
            x, m1, m2, m3 = s["x"], s["m1"], s["m2"], s["m3"]
            m0 = self._x0(network_output(fn, params, x, t, "UniPC"), x, alpha_s, sigma_s)
            # UniC refines the sample the network was just evaluated at.
            x_corr = c_cx * s["x_last"] + c_cm * m1 + cw0 * (m2 - m1) + cw1 * (m3 - m1) + cwt * (m0 - m1)
            x_used = torch.where(g > 0, x_corr, x)
            x_next = p_cx * x_used + p_cm * m0 + pw0 * (m1 - m0) + pw1 * (m2 - m0)
            m3.copy_(m2)
            m2.copy_(m1)
            m1.copy_(m0)
            s["x_last"].copy_(x_used)
            x.copy_(x_next)

        zeros = torch.zeros_like(x)
        state = {"x": x.clone(), "x_last": zeros, "m1": zeros.clone(), "m2": zeros.clone(), "m3": zeros.clone()}
        state = table_loop(self, "unipc", model_fn, params, state, table, step, M,
                           graphs_lib.use_graphs(graphs, x.device), frame=lambda s, row: s["x"], frames=frames)
        x = state["x"]
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out
