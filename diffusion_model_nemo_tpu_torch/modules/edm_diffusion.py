"""EDM-native diffusion (Karras et al. 2022): the VE path, the
preconditioned denoiser, the training σ distribution and Algorithm 2.

Counterpart of ``diffusion_model_nemo_tpu/modules/edm_diffusion.py``:

    x_σ = x0 + σ·ε,
    D(x; σ) = c_skip(σ)·x + c_out(σ)·F(c_in(σ)·x, c_noise(σ)·time_scale),
    c_skip = σ_d²/(σ² + σ_d²), c_out = σ·σ_d/√(σ² + σ_d²),
    c_in = 1/√(σ² + σ_d²), c_noise = ln(σ)/4,

ln σ ~ N(P_mean, P_std²) in training (``sigmas_from_normal`` takes the
standard normal draw, so a test injects the JAX draw), loss weight λ(σ) =
1/c_out². The network's time input is ``c_noise·time_scale`` as float32
(negative below σ = 1).

Sampling is Algorithm 2 on the ρ-spaced grid σ_max … σ_min, 0 (host float64
numpy, ``_sigma_grid`` / ``_solver_coefficients``, cast once to float32 as
in the JAX package): Heun runs M − 1 corrected steps and then one Euler
step to σ = 0 (NFE 2M − 1), Euler M steps. On CUDA the steps are replays of
one captured step (``table_loop``), the last Euler step a graph of its own;
the churn noise is drawn into a static buffer before each step in the eager
loop's order (``s_churn = 0`` draws nothing), or injected (``noise`` [M,
*shape]: the tests feed the JAX scan's draws). ``encode`` integrates the
probability-flow ODE up the ascending grid (Heun on every transition, no
final Euler, no churn), ``interpolate`` slerps two encodings and decodes,
and ``likelihood`` is the fixed-grid probability-flow NLL: the drift and the
Hutchinson term εᵀJε of every evaluation from one ``torch.autograd.grad``
(the JAX ``jax.vjp``), through the network's differentiable kernel calls;
the grid is fixed, so the whole step, forward and backward, is one
captured graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .gaussian_diffusion import _randn, new_frames
from .table_loop import device_table, draw_epsilon, ode_likelihood, slerp, table_loop

__all__ = ["EDMProcess"]

COLUMNS = ("sigma_hat", "noise_std", "sigma_next", "dt")


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


@register_target("diffusion_model_nemo.modules.EDMProcess", "diffusion_model_nemo_tpu.modules.EDMProcess")
class EDMProcess:
    """Stateless holder of the EDM path, preconditioning and sampler (the
    JAX class's arguments; ``device`` holds the step tables)."""

    use_class_conditioning = False
    objective = "edm_denoiser"

    def __init__(
        self,
        sample_steps: int = 18,
        solver: str = "heun",
        sigma_data: float = 0.5,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        p_mean: float = -1.2,
        p_std: float = 1.2,
        s_churn: float = 0.0,
        s_noise: float = 1.0,
        s_tmin: float = 0.0,
        s_tmax: float = float("inf"),
        time_scale: float = 250.0,
        clip_denoised: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if solver not in ("euler", "heun"):
            raise ValueError(f"solver must be euler|heun, got {solver!r}")
        if int(sample_steps) < 2:
            raise ValueError(f"sample_steps must be >= 2, got {sample_steps}")
        if not (0.0 < float(sigma_min) < float(sigma_max)):
            raise ValueError(f"need 0 < sigma_min < sigma_max, got {sigma_min}, {sigma_max}")
        if float(sigma_data) <= 0.0:
            raise ValueError(f"sigma_data must be > 0, got {sigma_data}")
        self.sample_steps = int(sample_steps)
        self.solver = str(solver)
        self.sigma_data = float(sigma_data)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.p_mean = float(p_mean)
        self.p_std = float(p_std)
        self.s_churn = float(s_churn)
        self.s_noise = float(s_noise)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.time_scale = float(time_scale)
        self.clip_denoised = bool(clip_denoised)
        self.device = torch.device(device)
        self.graphs: dict = {}  # the captured steps (table_loop)
        self._device_tables: Dict[str, torch.Tensor] = {}

    def table_tensors(self) -> Tuple[torch.Tensor, ...]:
        """No schedule table: the step tables are the sampler's own, built once."""
        return ()

    # ---- preconditioning (Table 1) ------------------------------------------
    def precond(self, sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(c_skip, c_out, c_in, c_noise) at σ, elementwise, float32."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        sd2 = self.sigma_data**2
        denom = sigma**2 + sd2
        c_skip = sd2 / denom
        c_out = sigma * self.sigma_data * torch.rsqrt(denom)
        c_in = torch.rsqrt(denom)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise

    def loss_weight(self, sigma: torch.Tensor) -> torch.Tensor:
        """λ(σ) = (σ² + σ_d²)/(σ·σ_d)² = 1/c_out²."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        return (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2

    def model_time(self, sigma: torch.Tensor) -> torch.Tensor:
        """The network's conditioning value at σ: c_noise·time_scale."""
        return 0.25 * torch.log(torch.as_tensor(sigma, dtype=torch.float32)) * self.time_scale

    # ---- training-side path -------------------------------------------------
    def sigmas_from_normal(self, z: torch.Tensor) -> torch.Tensor:
        """σ = exp(P_mean + P_std·z) for standard normal draws z [B] (eq. 6)."""
        return torch.exp(self.p_mean + self.p_std * z.float())

    def q_sample(self, x_start: torch.Tensor, sigma, noise: torch.Tensor) -> torch.Tensor:
        """x_σ = x0 + σ·ε (σ: [B] or 0-d)."""
        sigma = torch.as_tensor(sigma, dtype=x_start.dtype, device=x_start.device)
        return x_start + sigma.reshape(sigma.shape + (1,) * (x_start.ndim - sigma.ndim)) * noise

    def denoise(self, model_fn: ModelFn, params: Any, x: torch.Tensor, sigma,
                clip: Optional[bool] = None) -> torch.Tensor:
        """D(x; σ), σ [B] or 0-d (a device tensor in a captured step);
        ``clip`` (default ``clip_denoised``) clamps it to [−1, 1]."""
        B = x.shape[0]
        sigma_b = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).expand(B)
        c_skip, c_out, c_in, _ = self.precond(sigma_b.reshape((-1,) + (1,) * (x.ndim - 1)))
        F = model_fn(params, (c_in * x).to(x.dtype), self.model_time(sigma_b))
        D = c_skip * x + c_out * F
        if clip if clip is not None else self.clip_denoised:
            D = D.clamp(-1.0, 1.0)
        return D

    def _slope(self, fn, params, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """The probability-flow slope (x − D)/σ."""
        return (x - self.denoise(fn, params, x, sigma)) / sigma.clamp_min(1e-12)

    # ---- σ grid (eq. 5) -----------------------------------------------------
    def _steps(self, num_steps: Optional[int] = None) -> int:
        M = int(num_steps) if num_steps else self.sample_steps
        if M < 2:
            raise ValueError(f"num_steps must be >= 2, got {M}")
        return M

    def _sigma_grid(self, num_steps: Optional[int] = None) -> np.ndarray:
        """Descending [M+1] float64: ρ-spaced σ_max … σ_min, then 0."""
        M = self._steps(num_steps)
        inv_rho = 1.0 / self.rho
        ramp = np.linspace(0.0, 1.0, M)
        sig = (self.sigma_max**inv_rho + ramp * (self.sigma_min**inv_rho - self.sigma_max**inv_rho)) ** self.rho
        return np.concatenate([sig, [0.0]])

    def _solver_coefficients(self, num_steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Per transition i (σ_i → σ_{i+1}), [M] float32 each: sigma_hat (the
        churn-inflated start), noise_std = s_noise·√(σ̂² − σ_i²), sigma_next
        and dt = σ_{i+1} − σ̂."""
        sig = self._sigma_grid(num_steps)
        M = len(sig) - 1
        gamma = np.zeros(M)
        if self.s_churn > 0.0:
            g = min(self.s_churn / M, np.sqrt(2.0) - 1.0)
            in_window = (sig[:M] >= self.s_tmin) & (sig[:M] <= self.s_tmax)
            gamma = np.where(in_window, g, 0.0)
        sigma_hat = sig[:M] * (1.0 + gamma)
        noise_std = self.s_noise * np.sqrt(np.maximum(sigma_hat**2 - sig[:M] ** 2, 0.0))
        return {"sigma_hat": _f32(sigma_hat), "noise_std": _f32(noise_std), "sigma_next": _f32(sig[1:]),
                "dt": _f32(sig[1:] - sigma_hat)}

    def _encode_coefficients(self, num_steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The ascending grid σ_min … σ_max (no 0) as transitions: no churn."""
        sig = self._sigma_grid(num_steps)[:-1][::-1]
        return {"sigma_hat": _f32(sig[:-1]), "noise_std": _f32(np.zeros(len(sig) - 1)),
                "sigma_next": _f32(sig[1:]), "dt": _f32(sig[1:] - sig[:-1])}

    # ---- the steps ----------------------------------------------------------
    def _step_fns(self, params, stochastic: bool):
        """(heun, euler) steps on a state {"x", "noise"?} and a table row."""

        def euler_half(fn, s, row):
            sigma_hat, noise_std, _sigma_next, dt = row.unbind(0)
            x = s["x"]
            if stochastic:
                x = x + noise_std * s["noise"]
            d = self._slope(fn, params, x, sigma_hat)
            return x, x + dt * d, d

        def heun(fn, s, row):
            x, x_e, d = euler_half(fn, s, row)
            d2 = self._slope(fn, params, x_e, row[2])
            s["x"].copy_(x + row[3] * 0.5 * (d + d2))

        def euler(fn, s, row):
            s["x"].copy_(euler_half(fn, s, row)[1])

        return heun, euler

    def _integrate(self, model_fn, params, x: torch.Tensor, num_steps: Optional[int], generator,
                   graphs: bool, frames: Optional[torch.Tensor], noise: Optional[torch.Tensor]) -> torch.Tensor:
        """Algorithm 2 from x (σ_max scale) on the descending grid."""
        M = self._steps(num_steps)
        coefs = lambda: self._solver_coefficients(M)  # noqa: E731
        table = device_table(self, f"edm_{M}", coefs, COLUMNS)
        stochastic = self.s_churn > 0.0
        if noise is not None and tuple(noise.shape) != (M, *x.shape):
            raise ValueError(f"noise must be [M, *shape] = {[M, *x.shape]}, got {list(noise.shape)}")

        def draw(s, i):
            if noise is not None:
                s["noise"].copy_(noise[i])
            else:
                s["noise"].normal_(generator=generator)

        heun, euler = self._step_fns(params, stochastic)
        state = {"x": x.clone()}
        if stochastic:
            state["noise"] = torch.empty_like(x)
        frame = lambda s, row: s["x"]  # noqa: E731
        churn = draw if stochastic else None
        if self.solver == "euler":
            return table_loop(self, "edm_euler", model_fn, params, state, table, euler, M, graphs, draw=churn,
                              frame=frame, frames=frames)["x"]
        state = table_loop(self, "edm_heun", model_fn, params, state, table, heun, M - 1, graphs, draw=churn,
                           frame=frame, frames=frames)
        last = device_table(self, f"edm_last_{M}", coefs, COLUMNS, rows=slice(M - 1, M))
        state = {k: v for k, v in state.items() if k in ("x", "noise")}
        return table_loop(self, "edm_last", model_fn, params, state, last, euler, 1, graphs,
                          draw=(lambda s, i: draw(s, M - 1)) if stochastic else None, frame=frame,
                          frames=None if frames is None else frames[M - 1:])["x"]

    # ---- public sampling surface ---------------------------------------------
    def p_sample_loop(
        self,
        model_fn: ModelFn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        img: Optional[torch.Tensor] = None,
        num_steps: Optional[int] = None,
        return_frames: bool = False,
        unnormalize: bool = True,
        graphs: Optional[bool] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """Algorithm 2: x ~ N(0, σ_max²) from ``generator`` (or ``img``) → data,
        [B, H, W, C] in [0, 1] (``unnormalize``); then the churn draws, one a
        step, or ``noise[i]``. ``return_frames``: (out, frames [M, *shape],
        (x + 1)/2 after each step). ``graphs``: replay captured steps
        (default: on CUDA) or run the Python loop; the same numbers."""
        if img is None:
            img = _randn(tuple(shape), generator, self.device) * self.sigma_max
        M = self._steps(num_steps)
        frames = new_frames(M, img) if return_frames else None
        x = self._integrate(model_fn, params, img.float(), num_steps, generator,
                            graphs_lib.use_graphs(graphs, img.device), frames, noise)
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out

    def encode(self, model_fn: ModelFn, params: Any, x0: torch.Tensor, num_steps: Optional[int] = None,
               graphs: Optional[bool] = None) -> torch.Tensor:
        """Data ([−1, 1]) → latent on the N(0, σ_max²) scale: the
        probability-flow ODE up the ascending grid σ_min … σ_max, Heun on
        every transition (deterministic; the σ_min → 0 tail is skipped)."""
        M = self._steps(num_steps)
        table = device_table(self, f"edm_encode_{M}", lambda: self._encode_coefficients(M), COLUMNS)
        heun, _euler = self._step_fns(params, False)
        state = table_loop(self, "edm_encode", model_fn, params, {"x": x0.float().clone()}, table, heun, M - 1,
                           graphs_lib.use_graphs(graphs, x0.device))
        return state["x"].clone()

    draw_epsilon = draw_epsilon  # the trace probe: Rademacher ±1 or a standard normal

    def likelihood(
        self,
        model_fn: ModelFn,
        params: Any,
        data: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        num_steps: Optional[int] = None,
        hutchinson_type: str = "rademacher",
        epsilon: Optional[torch.Tensor] = None,
        graphs: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(bits/dim [B], latent z, NFE) of ``data`` ([−1, 1]) through the
        probability-flow ODE from σ_min to σ_max on the fixed grid, prior
        N(0, σ_max² + σ_d²), +7 bits for data scaled from [0, 256]; NFE =
        2(M − 1) for Heun, M − 1 for Euler. ``model_fn`` must let autograd
        through (the model's ``train_model_fn``); ``epsilon`` injects the
        probe, else it is drawn from ``generator``."""
        M = self._steps(num_steps)
        heun = self.solver == "heun"
        table = device_table(self, f"edm_encode_{M}", lambda: self._encode_coefficients(M), COLUMNS)

        def times(row):  # dt in float32, as JAX takes it here (encode's is float64's, cast)
            return row[0], row[2], row[2] - row[0]

        def field(fn, x, sigma):
            return (x - self.denoise(fn, params, x, sigma, clip=False)) / sigma.clamp_min(1e-12)

        bpd, z = ode_likelihood(self, "edm_nll", model_fn, params, data, table, M - 1, times, field, heun,
                                graphs_lib.use_graphs(graphs, data.device), generator, hutchinson_type, epsilon,
                                prior_var=self.sigma_max**2 + self.sigma_data**2)
        nfe = 2 * (M - 1) if heun else M - 1
        return bpd, z, torch.tensor(float(nfe), dtype=torch.float32, device=data.device)

    def interpolate(self, model_fn: ModelFn, params: Any, x1: torch.Tensor, x2: torch.Tensor,
                    generator: Optional[torch.Generator] = None, t: Optional[int] = None, lambd: float = 0.5,
                    graphs: Optional[bool] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latent slerp: encode both batches (in [0, 1] display space), slerp
        at ``lambd``, decode with Algorithm 2 (``t`` overrides the grid
        size; ``generator`` / ``noise`` only feed churn). [B, H, W, C] in
        [0, 1]."""
        num_steps = int(t) if t else None
        z1 = self.encode(model_fn, params, x1 * 2.0 - 1.0, num_steps, graphs)
        z2 = self.encode(model_fn, params, x2 * 2.0 - 1.0, num_steps, graphs)
        z = slerp(z1, z2, lambd)
        return self.p_sample_loop(model_fn, params, tuple(z.shape), generator, img=z, num_steps=num_steps,
                                  graphs=graphs, noise=noise)
