"""SDE samplers: the predictor–corrector chain and the probability-flow ODE.

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_samplers.py``:

- :class:`PredictorCorrectorSampler`: a prior draw, then per step of the
  grid T → eps (N float32 values, JAX's ``linspace``) the corrector, then
  the predictor; the output is the last ``x_mean`` (``denoise``) or ``x``,
  mapped to [0, 1]; NFE = N·(n_steps + 1). The JAX package scans the step
  (``lax.scan``); here, on CUDA, step 0 runs eagerly and steps 1 … N−1 are
  replays of one captured step (``ops/graphs.py``) with t = grid[i] read on
  the device from a step counter that the step advances. Draws, before
  each step, into one buffer [n, *shape] in a fixed order: the corrector's
  ``n_steps`` normals, then the predictor's one (none for "none"); eager
  and replayed chains draw the same numbers and agree bit for bit.
  ``noise`` [N, n, *shape] injects them instead (and ``x_T`` the prior
  draw): the tests feed the JAX chain's draws.
- :class:`ProbabilityFlowSampler`: RK45 (``ops/ode.py``) on the
  probability-flow drift from T to eps, an optional denoising step through
  the reverse-diffusion predictor (x_mean: no draw), the output in [0, 1]
  and the NFE.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from ..ops.ode import odeint_rk45, poison_on_failure
from .gaussian_diffusion import graph_key
from .sde_correctors import NoneCorrector, get_corrector
from .sde_lib.score_fn import probability_flow_drift, resolve_score_function
from .sde_lib.sde_lib import SDE, take
from .sde_predictors import NonePredictor, ReverseDiffusionPredictor, get_predictor

__all__ = ["PredictorCorrectorSampler", "ProbabilityFlowSampler"]


def _check_sde(sampler) -> SDE:
    if sampler.sde is None:
        raise ValueError("Must explicitly set `update_sde(sde)` prior to sampling")
    return sampler.sde


@register_target("diffusion_model_nemo.modules.PredictorCorrectorSampler")
class PredictorCorrectorSampler:
    def __init__(
        self,
        predictor: Optional[str],
        corrector: Optional[str],
        snr: float,
        n_steps: int = 1,
        probability_flow: bool = False,
        continuous: bool = True,
        denoise: bool = True,
        eps: Optional[float] = None,
    ):
        self.predictor = predictor
        self.corrector = corrector
        self.snr = snr
        self.n_steps = n_steps
        self.probability_flow = probability_flow
        self.continuous = continuous
        self.denoise = denoise
        self.eps = eps
        self.sde: Optional[SDE] = None
        self.version = 0
        self.graphs: dict = {}  # the captured PC step (ops/graphs.py)

    def update_sde(self, sde: SDE) -> None:
        self.sde = sde
        self.version += 1

    def _build(self, model_fn):
        """The score function, the predictor and the corrector."""
        score_fn = resolve_score_function(model_fn, sde=self.sde, continuous=self.continuous)
        pred_cls = get_predictor(self.predictor) if self.predictor else None
        corr_cls = get_corrector(self.corrector) if self.corrector else None
        predictor = (pred_cls or NonePredictor)(
            sde=self.sde, score_fn=score_fn, probability_flow=self.probability_flow
        )
        corrector = (corr_cls or NoneCorrector)(
            sde=self.sde, score_fn=score_fn, snr=self.snr, n_steps=self.n_steps
        )
        return score_fn, predictor, corrector

    @staticmethod
    def pc_step(predictor, corrector, params, x, t, z):
        """Corrector then predictor at ``t`` with the step's draws ``z``
        [n, *x.shape]: (x, x_mean)."""
        n_c = corrector.draws
        x, x_mean = corrector.update_fn(params, x, t, z[:n_c] if n_c else None)
        return predictor.update_fn(params, x, t, z[n_c] if predictor.draws else None)

    def time_grid(self) -> torch.Tensor:
        eps = self.sde.sampling_epsilon if self.eps is None else self.eps
        return self.sde.time_grid(eps)

    def sample(
        self,
        model_fn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        x_T: Optional[torch.Tensor] = None,
        return_nfe: bool = False,
        graphs: Optional[bool] = None,
        num_steps: Optional[int] = None,
    ):
        """The PC chain; returns the images in [0, 1] (and the NFE).
        ``graphs``: replay a captured step (default: on CUDA) or run the
        Python loop; both draw the same numbers from ``generator``.
        ``num_steps``: only the chain's first steps (a prefix of the grid;
        the output is that step's)."""
        sde = _check_sde(self)
        _, predictor, corrector = self._build(model_fn)
        n = corrector.draws + predictor.draws
        N = sde.N if num_steps is None else min(int(num_steps), sde.N)
        if noise is not None and tuple(noise.shape) != (N, n, *shape):
            raise ValueError(f"noise must be [N, draws, *shape] = {[N, n, *shape]}, got {list(noise.shape)}")
        x = x_T if x_T is not None else sde.prior_sampling(shape, generator)
        grid = self.time_grid().to(x.device)

        def fill(z: torch.Tensor, i: int) -> None:
            if noise is not None:
                z.copy_(noise[i])
            elif n:
                z.normal_(generator=generator)

        if graphs_lib.use_graphs(graphs, x.device):
            x, x_mean = self._pc_replays(model_fn, predictor, corrector, params, x, grid, n, fill, N)
        else:
            z = torch.empty((n, *x.shape), dtype=torch.float32, device=x.device)
            x_mean = x
            for i in range(N):
                fill(z, i)
                x, x_mean = self.pc_step(predictor, corrector, params, x, grid[i], z)
        out = x_mean if self.denoise else x
        out = (out + 1.0) * 0.5
        nfe = N * (self.n_steps + 1)
        return (out, nfe) if return_nfe else out

    def _pc_replays(self, model_fn, predictor, corrector, params, x, grid, n: int, fill, N: int):
        """Steps 0 … N−1 through one captured ``pc_step`` (static x, x_mean
        and draws; a step counter i on the device, t = grid[i]); step 0 is
        the capture's warm-up. ``model_fn`` keys the graph. Returns (x,
        x_mean)."""
        static = None

        def build():
            nonlocal static
            static = {"x": x.clone(), "x_mean": x.clone(), "grid": grid.clone(),
                      "z": torch.empty((n, *x.shape), dtype=torch.float32, device=x.device),
                      "i": torch.zeros((), dtype=torch.long, device=x.device)}

            def step():
                t = take(static["grid"], static["i"])
                x_new, x_mean = self.pc_step(predictor, corrector, params, static["x"], t, static["z"])
                static["x"].copy_(x_new)
                static["x_mean"].copy_(x_mean)
                static["i"].add_(1)

            def warmup():  # the chain's first step
                fill(static["z"], 0)
                step()

            return graphs_lib.Graph("pc", step, static, device=x.device, warmup=warmup)

        key = ("pc", tuple(x.shape), x.dtype, x.device, self.version, tuple(grid.shape), *graph_key(model_fn))
        sde_tables = tuple(v for v in vars(self.sde).values() if torch.is_tensor(v))
        graph, built = graphs_lib.cached(self.graphs, key, (*(params or {}).values(), *sde_tables), build)
        static = graph.static
        if not built:
            static["x"].copy_(x)
            static["grid"].copy_(grid)
            static["i"].zero_()
        for i in range(1 if built else 0, N):
            fill(static["z"], i)
            graph.replay()
        return static["x"].clone(), static["x_mean"].clone()

    forward = sample


@register_target("diffusion_model_nemo.modules.ProbabilityFlowSampler")
class ProbabilityFlowSampler:
    def __init__(
        self,
        method: str = "RK45",
        rtol: float = 1e-5,
        atol: float = 1e-5,
        denoise: bool = False,
        eps: Optional[float] = None,
        max_steps: int = 10_000,
    ):
        if method.upper() != "RK45":
            raise ValueError("Only RK45 (Dormand-Prince) is supported in-graph")
        self.rtol = rtol
        self.atol = atol
        self.denoise = denoise
        self.eps = eps
        self.max_steps = max_steps
        self.sde: Optional[SDE] = None
        self.version = 0
        self.graphs: dict = {}  # the captured RK45 step (ops/ode.py)

    def update_sde(self, sde: SDE) -> None:
        self.sde = sde
        self.version += 1

    def denoise_update_fn(self, model_fn, params, x, eps: float):
        """The reverse-diffusion step at t = eps, its mean (no draw)."""
        score_fn = resolve_score_function(model_fn, self.sde, continuous=True)
        predictor = ReverseDiffusionPredictor(self.sde, score_fn, probability_flow=False)
        t = torch.tensor(np.float32(eps), device=x.device)
        _, x_mean = predictor.update_fn(params, x, t, None)
        return x_mean

    def sample(
        self,
        model_fn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        return_nfe: bool = False,
        graphs: Optional[bool] = None,
    ):
        """RK45 from the prior draw (or ``noise``) at T to eps; returns the
        images in [0, 1] (and the NFE, a 0-d tensor). ``graphs``: replay a
        captured RK step (default: on CUDA) or run it eagerly."""
        sde = _check_sde(self)
        eps = sde.sampling_epsilon if self.eps is None else self.eps
        x = sde.prior_sampling(shape, generator) if noise is None else noise

        def ode_func(t, y):
            return probability_flow_drift(model_fn, sde, params, y, t)

        sol = odeint_rk45(
            ode_func, x, sde.T, eps, rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
            graphs=graphs_lib.use_graphs(graphs, x.device), store=self.graphs,
            key=("pf", self.version, *graph_key(model_fn)), sources=tuple((params or {}).values()),
        )
        # Solver exhaustion must not pass as a converged sample.
        x = poison_on_failure(sol, sol.y, "probability-flow sampling")
        if self.denoise:
            x = self.denoise_update_fn(model_fn, params, x, eps)
        x = (x + 1.0) * 0.5
        return (x, sol.nfev) if return_nfe else x

    forward = sample
