"""Bits/dim of data through the probability-flow ODE (Hutchinson–Skilling).

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/likelihood.py``:
Rademacher or Gaussian ε (drawn from a generator, or injected); at every
evaluation the drift and εᵀJε come from one ``torch.autograd.grad`` with
``grad_outputs=ε`` (the JAX package's one ``jax.vjp``), through the
network's differentiable kernel calls, whose backward recomputes the
plain versions; the augmented ODE over (x, logp) integrates with RK45 from
eps to T (``ops/ode.py``; on CUDA one captured step, forward and backward,
replayed); then the prior's log-density and bits/dim with the +7 offset of
data scaled to [−1, 1] from [0, 256].
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...config.registry import register_target
from ...ops import graphs as graphs_lib
from ...ops.ode import odeint_rk45, poison_on_failure
from ..gaussian_diffusion import graph_key
from .score_fn import probability_flow_drift
from .sde_lib import SDE

__all__ = ["LikelihoodEstimate"]


@register_target("diffusion_model_nemo.modules.LikelihoodEstimate",
                 "diffusion_model_nemo.modules.sde_lib.LikelihoodEstimate")
class LikelihoodEstimate:
    def __init__(
        self,
        hutchinson_type: str = "rademacher",
        method: str = "RK45",
        rtol: float = 1e-5,
        atol: float = 1e-5,
        eps: float = 1e-5,
        max_steps: int = 10_000,
    ):
        hutchinson_type = hutchinson_type.lower()
        if hutchinson_type not in ("rademacher", "gaussian"):
            raise ValueError("`hutchinson_type` must be one of `rademacher` or `gaussian`")
        if method.upper() != "RK45":
            raise ValueError("Only RK45 (Dormand-Prince) is supported in-graph")
        self.hutchinson_type = hutchinson_type
        self.rtol = rtol
        self.atol = atol
        self.eps = eps
        self.max_steps = max_steps
        self.sde: Optional[SDE] = None
        self.version = 0
        self.graphs: dict = {}  # the captured RK45 step (ops/ode.py)

    def update_sde(self, sde: SDE) -> None:
        self.sde = sde
        self.version += 1

    def draw_epsilon(self, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """The trace probe: Rademacher ±1 or a standard normal."""
        if self.hutchinson_type == "gaussian":
            return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
        bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
        return bits.to(torch.float32) * 2.0 - 1.0

    def likelihood(
        self,
        model_fn,
        params: Any,
        data: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        epsilon: Optional[torch.Tensor] = None,
        graphs: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(bits/dim [B], latent z, NFE). ``model_fn`` must let autograd
        through (the model's ``train_model_fn``); ``epsilon`` injects the
        probe, else it is drawn from ``generator``. ``graphs``: replay a
        captured RK step (default: on CUDA) or run it eagerly."""
        if self.sde is None:
            raise ValueError("Must explicitly set `update_sde(sde)` first")
        shape = tuple(data.shape)
        B = shape[0]
        with torch.inference_mode(False), torch.no_grad():
            x0 = data.to(torch.float32).clone()
            eps = (self.draw_epsilon(shape, generator, data.device) if epsilon is None
                   else epsilon.to(torch.float32).clone())
            dims = tuple(range(1, len(shape)))

            def ode_func(t, state, inputs):
                """Drift and the Hutchinson divergence εᵀJε from one vjp."""
                x, _logp = state
                probe = inputs["epsilon"]
                with torch.enable_grad():
                    xg = x.detach().requires_grad_(True)
                    drift = probability_flow_drift(model_fn, self.sde, params, xg, t)
                    (eps_J,) = torch.autograd.grad(drift, xg, grad_outputs=probe)
                div = torch.sum(eps_J * probe, dim=dims)
                return drift.detach(), div

            init = (x0, torch.zeros((B,), dtype=torch.float32, device=data.device))
            sol = odeint_rk45(
                ode_func, init, self.eps, self.sde.T, rtol=self.rtol, atol=self.atol,
                max_steps=self.max_steps, inputs={"epsilon": eps},
                graphs=graphs_lib.use_graphs(graphs, data.device), store=self.graphs,
                key=("likelihood", self.version, *graph_key(model_fn)), sources=tuple((params or {}).values()),
            )
            # Solver exhaustion would silently corrupt bits/dim: NaN-poison instead.
            z, delta_logp = poison_on_failure(sol, sol.y, "likelihood estimation")
            prior_logp = self.sde.prior_logp(z)
            N = int(np.prod(shape[1:]))
            bpd = -(prior_logp + delta_logp) / float(np.log(2))
            bpd = bpd / N
            # +7 = ln(128)/ln(2): data scaled to [-1, 1] from [0, 256].
            bpd = bpd + 7.0
            return bpd, z, sol.nfev
