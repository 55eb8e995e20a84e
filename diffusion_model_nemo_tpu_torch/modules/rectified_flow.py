"""Rectified flow / conditional flow matching (Liu et al. 2022; Lipman et
al. 2022): the linear path, its velocity target and the ODE sampler.

Counterpart of ``diffusion_model_nemo_tpu/modules/rectified_flow.py``:

    x_t = (1 − t)·x0 + t·ε,   t ∈ [0, 1],   v_θ(x_t, t) ← ε − x0,

and sampling integrates dx/dt = v_θ from t = 1 (noise) to t = 0 (data) on
a fixed linear grid of M transitions. The network sees t·``time_scale`` as
float32. Training's t is uniform on [0, 1] or logit-normal
(σ(mean + std·z)); ``sample_times`` maps the injected draw (u or z, [B]) to
t, ``draw_times`` draws it from a ``torch.Generator``.

The grid (t, t_next, dt) is computed in float64 numpy and only then cast
to float32, as in the JAX package (dt is not the difference of the cast
times), and held as one device table (``table_loop.device_table``). On
CUDA each loop is the replay of one captured step (``table_loop``):

- ``p_sample_loop``: Euler runs M steps; Heun runs M − 1 corrected steps
  and then one plain Euler step (its own graph), NFE 2M − 1; at M = 1 Heun
  is Euler. Frames are (x + 1)/2 after every step, the tail's included.
- ``encode``: the same rule up the ascending grid 0 → 1.
- ``likelihood``: the exact NLL by the instantaneous change of variables
  on the ascending grid (``table_loop.ode_likelihood``, EDM's too), Heun on
  all M transitions (NFE 2M; Euler M), prior N(0, I), +7 bits. The two
  Heun rules differ as the JAX package has them.
- ``interpolate``: encode both batches, slerp the latents
  (``table_loop.slerp``), decode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from .diffusion_process import ModelFn
from .gaussian_diffusion import _randn, batched_t, new_frames
from .table_loop import device_table, draw_epsilon, ode_likelihood, slerp, table_loop

__all__ = ["RectifiedFlowProcess"]

COLUMNS = ("t", "t_next", "dt")


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


@register_target(
    "diffusion_model_nemo.modules.RectifiedFlowProcess",
    "diffusion_model_nemo_tpu.modules.RectifiedFlowProcess",
)
class RectifiedFlowProcess:
    """Stateless holder of the flow-matching path and its ODE sampler (the
    JAX class's arguments; ``device`` holds the grid tables)."""

    use_class_conditioning = False
    objective = "pred_velocity"

    def __init__(
        self,
        sample_steps: int = 50,
        solver: str = "euler",
        time_scale: float = 1000.0,
        time_sampling: str = "uniform",
        logit_mean: float = 0.0,
        logit_std: float = 1.0,
        clip_denoised: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if solver not in ("euler", "heun"):
            raise ValueError(f"solver must be euler|heun, got {solver!r}")
        if time_sampling not in ("uniform", "logit_normal"):
            raise ValueError(f"time_sampling must be uniform|logit_normal, got {time_sampling!r}")
        if int(sample_steps) < 1:
            raise ValueError(f"sample_steps must be >= 1, got {sample_steps}")
        self.sample_steps = int(sample_steps)
        self.solver = str(solver)
        self.time_scale = float(time_scale)
        self.time_sampling = str(time_sampling)
        self.logit_mean = float(logit_mean)
        self.logit_std = float(logit_std)
        self.clip_denoised = bool(clip_denoised)  # unused, as in the JAX package
        self.device = torch.device(device)
        self.graphs: dict = {}  # the captured steps (table_loop)
        self._device_tables: Dict[str, torch.Tensor] = {}

    def table_tensors(self) -> Tuple[torch.Tensor, ...]:
        """No schedule table: the grid tables are the sampler's own."""
        return ()

    # ---- training-side path -------------------------------------------------
    def draw_times(self, batch: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The raw draw behind ``sample_times``: u ~ U[0, 1) [B], or z ~ N(0, 1)
        [B] under ``logit_normal``."""
        if self.time_sampling == "logit_normal":
            return _randn((batch,), generator, self.device)
        return torch.rand((batch,), generator=generator, device=self.device, dtype=torch.float32)

    def sample_times(self, draw: torch.Tensor) -> torch.Tensor:
        """Path times t ∈ [0, 1] [B] from the draw: u itself, or σ(mean + std·z)."""
        draw = draw.float()
        if self.time_sampling == "logit_normal":
            return torch.sigmoid(self.logit_mean + self.logit_std * draw)
        return draw

    def q_sample(self, x_start: torch.Tensor, t, noise: torch.Tensor) -> torch.Tensor:
        """The point on the linear path, x_t = (1 − t)·x0 + t·ε (t: [B] or 0-d)."""
        t = torch.as_tensor(t, dtype=x_start.dtype, device=x_start.device)
        t = t.reshape(t.shape + (1,) * (x_start.ndim - t.ndim))
        return (1.0 - t) * x_start + t * noise

    def v_target(self, x_start: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The regression target: the path's constant velocity ε − x0."""
        return noise - x_start

    def model_time(self, t) -> torch.Tensor:
        """The network's conditioning value at path time t: t·time_scale, float32."""
        return torch.as_tensor(t, dtype=torch.float32) * self.time_scale

    # ---- the grid -------------------------------------------------------------
    def _steps(self, num_steps: Optional[int]) -> int:
        M = int(num_steps) if num_steps else self.sample_steps
        if M < 1:
            raise ValueError(f"num_steps must be >= 1, got {M}")
        return M

    def _grid(self, num_steps: Optional[int], reverse: bool) -> Dict[str, np.ndarray]:
        """The [M] float32 vectors t, t_next, dt of the float64 grid 1 → 0
        (``reverse``: 0 → 1); dt carries the sign."""
        M = self._steps(num_steps)
        grid = np.linspace(0.0, 1.0, M + 1) if reverse else np.linspace(1.0, 0.0, M + 1)
        return {"t": _f32(grid[:-1]), "t_next": _f32(grid[1:]), "dt": _f32(grid[1:] - grid[:-1])}

    def _table(self, M: int, reverse: bool, rows: Optional[slice] = None) -> torch.Tensor:
        name = f"rf_{'up' if reverse else 'down'}_{M}" + ("" if rows is None else f"_{rows.start}:{rows.stop}")
        return device_table(self, name, lambda: self._grid(M, reverse), COLUMNS, rows=rows)

    # ---- the steps --------------------------------------------------------------
    def _velocity(self, fn, params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return fn(params, x, batched_t(self.model_time(t), x))

    def _step_fns(self, params):
        """(heun, euler) steps on a state {"x"} and a table row (t, t_next, dt)."""

        def euler(fn, s, row):
            t, _t_next, dt = row.unbind(0)
            s["x"].copy_(s["x"] + dt * self._velocity(fn, params, s["x"], t))

        def heun(fn, s, row):
            t, t_next, dt = row.unbind(0)
            x = s["x"]
            v = self._velocity(fn, params, x, t)
            v2 = self._velocity(fn, params, x + dt * v, t_next)
            x.copy_(x + dt * 0.5 * (v + v2))

        return heun, euler

    def _integrate(self, model_fn, params, x: torch.Tensor, num_steps: Optional[int], reverse: bool,
                   graphs: bool, frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """dx/dt = v_θ over the grid from x: Euler M steps, or Heun M − 1
        steps then one Euler step (M > 1); ``frames[i]`` gets (x + 1)/2
        after step i. Returns x (a graph's static buffer: copy it)."""
        M = self._steps(num_steps)
        heun, euler = self._step_fns(params)
        way = "up" if reverse else "down"
        frame = lambda s, row: s["x"]  # noqa: E731
        state = {"x": x.clone()}
        if self.solver == "euler" or M == 1:
            return table_loop(self, f"rf_{way}_euler", model_fn, params, state, self._table(M, reverse), euler, M,
                              graphs, frame=frame, frames=frames)["x"]
        state = table_loop(self, f"rf_{way}_heun", model_fn, params, state, self._table(M, reverse), heun, M - 1,
                           graphs, frame=frame, frames=frames)
        last = self._table(M, reverse, rows=slice(M - 1, M))
        return table_loop(self, f"rf_{way}_last", model_fn, params, {"x": state["x"]}, last, euler, 1, graphs,
                          frame=frame, frames=None if frames is None else frames[M - 1:])["x"]

    # ---- public sampling surface ---------------------------------------------------
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
    ):
        """Noise (from ``generator``, or ``img``) → data: [B, H, W, C] in
        [0, 1] (``unnormalize``; else in data space); ``return_frames``:
        (out, frames [M, *shape]). ``graphs``: replay captured steps
        (default: on CUDA) or run the Python loop; the same numbers."""
        if img is None:
            img = _randn(tuple(shape), generator, self.device)
        M = self._steps(num_steps)
        frames = new_frames(M, img) if return_frames else None
        x = self._integrate(model_fn, params, img.float(), M, False, graphs_lib.use_graphs(graphs, img.device),
                            frames)
        out = (x + 1.0) * 0.5 if unnormalize else x.clone()
        return (out, frames) if return_frames else out

    def encode(self, model_fn: ModelFn, params: Any, x0: torch.Tensor, num_steps: Optional[int] = None,
               graphs: Optional[bool] = None) -> torch.Tensor:
        """Data ([−1, 1]) → latent: the same ODE and rule up the grid 0 → 1
        (deterministic; the inverse of ``p_sample_loop`` up to solver error)."""
        x = self._integrate(model_fn, params, x0.float(), num_steps, True, graphs_lib.use_graphs(graphs, x0.device))
        return x.clone()

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
        """(bits/dim [B], latent z, NFE) of ``data`` ([−1, 1]): the
        augmented [x, log det] state up the grid 0 → 1, Heun on every
        transition (NFE 2M) or Euler (M), prior N(0, I), +7 bits for data
        scaled from [0, 256]. ``model_fn`` must let autograd through (the
        model's ``train_model_fn``); ``epsilon`` injects the probe, else it
        is drawn from ``generator``."""
        M = self._steps(num_steps)
        heun = self.solver == "heun"
        field = lambda fn, x, t: self._velocity(fn, params, x, t)  # noqa: E731
        bpd, z = ode_likelihood(self, "rf_nll", model_fn, params, data, self._table(M, True), M,
                                lambda row: row.unbind(0), field, heun, graphs_lib.use_graphs(graphs, data.device),
                                generator, hutchinson_type, epsilon)
        nfe = 2 * M if heun else M
        return bpd, z, torch.tensor(float(nfe), dtype=torch.float32, device=data.device)

    def interpolate(self, model_fn: ModelFn, params: Any, x1: torch.Tensor, x2: torch.Tensor,
                    generator: Optional[torch.Generator] = None, t: Optional[int] = None, lambd: float = 0.5,
                    graphs: Optional[bool] = None) -> torch.Tensor:
        """Latent slerp: encode both batches (in [0, 1] display space), slerp
        at ``lambd``, decode (``t`` overrides the grid size; the flow is
        deterministic, ``generator`` is unused). [B, H, W, C] in [0, 1]."""
        del generator
        num_steps = int(t) if t else None
        z1 = self.encode(model_fn, params, x1 * 2.0 - 1.0, num_steps, graphs)
        z2 = self.encode(model_fn, params, x2 * 2.0 - 1.0, num_steps, graphs)
        z = slerp(z1, z2, lambd)
        return self.p_sample_loop(model_fn, params, tuple(z.shape), img=z, num_steps=num_steps, graphs=graphs)
