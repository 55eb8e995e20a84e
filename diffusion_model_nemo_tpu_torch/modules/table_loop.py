"""The table-driven chains (DDIM, DPM-Solver++, UniPC, Karras) as replays
of one captured step.

The JAX package feeds each chain's per-step values to ``lax.scan`` as xs:
DDIM's (t, t_next), the solvers' [M] scalars precomputed on the host in
float64 (``_solver_coefficients``, ``_unipc_coefficients``), cast once to
float32. Here they are one device table [M, K] (``device_table``, built
once a sampler and held by it), and a step reads its row through a 0-d
device counter that it advances itself, so a replay needs nothing from the
host. The solver's multistep memory (DPM's previous x̂₀, UniPC's x̂₀ ring
and corrected sample) and the step's noise (DDIM's at η > 0, Karras's
churn) live in static buffers, set before every chain: the order-1 first
and last steps come from zero weights in the table, never from a host
branch. ``graphs=False`` (and the CPU) runs the same step function eagerly
on ``table[i]``, the same numbers, so the two loops agree bit for bit.

The ODE families (EDM, rectified flow) share two pieces built on it:
``ode_likelihood``, the exact NLL on a fixed grid, and ``slerp``, the
latent interpolation between two encodings.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import graphs as graphs_lib
from .gaussian_diffusion import _randn, fill_static, graph_key, put_frame, static_model_fn

__all__ = ["device_table", "draw_epsilon", "ode_likelihood", "slerp", "table_loop"]

Step = Callable[[Any, Dict[str, torch.Tensor], torch.Tensor], None]
Row = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def device_table(sampler, name: str, coefficients: Callable[[], Dict[str, np.ndarray]], columns: Sequence[str],
                 rows: Optional[slice] = None, dtype=np.float32) -> torch.Tensor:
    """The vectors that ``coefficients()`` computes on the host (their
    ``rows``, default all), as the ``dtype`` columns of one [M, K] table on
    the sampler's device (DDIM's integer (t, t_next), the solvers' float32
    scalars), kept by the sampler under ``name`` (``_device_tables``) until
    its ``compute_constants``: a graph is held to this tensor, so a new
    schedule captures anew."""
    table = sampler._device_tables.get(name)
    if table is None:
        coefs = coefficients()
        host = np.stack([np.asarray(coefs[c], dtype) for c in columns], axis=1)[rows or slice(None)]
        table = torch.from_numpy(np.ascontiguousarray(host)).to(sampler.device)
        sampler._device_tables[name] = table
    return table


def table_loop(sampler, name: str, model_fn, params, state: Dict[str, torch.Tensor], table: torch.Tensor,
               step: Step, n: int, graphs: bool, draw: Optional[Callable[[Dict[str, torch.Tensor], int], None]] = None,
               frame: Optional[Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]] = None,
               frames: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``step(model_fn, state, row)`` for the rows 0 … n−1 of ``table``: it
    updates the tensors of ``state`` (the caller's own, made for this
    chain) in place. ``draw(state, i)`` fills step i's noise buffer before
    it; ``frames[i]`` gets ``(frame(state, row) + 1) / 2`` after it. With
    ``graphs`` the step is captured once (its first call eager, the
    capture's warm-up) and replayed with a device counter; returns the
    state (the graph's static buffers then)."""
    if not graphs:
        for i in range(n):
            if draw is not None:
                draw(state, i)
            step(model_fn, state, table[i])
            if frames is not None:
                put_frame(frames, i, frame(state, table[i]))
        return state
    dev = table.device
    static = None

    def build():
        nonlocal static
        static = {k: v.clone() for k, v in state.items()}
        static["i"] = torch.zeros((), dtype=torch.long, device=dev)
        fn = static_model_fn(model_fn, static)

        def replayed():
            step(fn, static, table.index_select(0, static["i"].reshape(1))[0])
            static["i"].add_(1)

        def warmup():  # the chain's first step
            if draw is not None:
                draw(static, 0)
            replayed()

        return graphs_lib.Graph(name, replayed, static, device=dev, warmup=warmup)

    key = (name, tuple(table.shape), table.dtype, tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(state.items())), dev,
           *graph_key(model_fn))
    graph, built = graphs_lib.cached(sampler.graphs, key,
                                     (*(params or {}).values(), table, *sampler.table_tensors()), build)
    static = graph.static
    if not built:
        for k, v in state.items():
            static[k].copy_(v)
        static["i"].zero_()
        fill_static(model_fn, static)
    for i in range(n):
        if i >= int(built):
            if draw is not None:
                draw(static, i)
            graph.replay()
        if frames is not None:
            put_frame(frames, i, frame(static, table[i]))
    return static


def draw_epsilon(sampler, shape, generator: Optional[torch.Generator], hutchinson_type: str = "rademacher"):
    """The trace probe on the sampler's device: Rademacher ±1 or a standard
    normal (a sampler's ``draw_epsilon`` method)."""
    if hutchinson_type == "gaussian":
        return _randn(tuple(shape), generator, sampler.device)
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=sampler.device)
    return bits.to(torch.float32) * 2.0 - 1.0


def ode_likelihood(sampler, name: str, model_fn, params, data: torch.Tensor, table: torch.Tensor, n: int,
                   times: Callable[[torch.Tensor], Row], field: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
                   heun: bool, graphs: bool, generator: Optional[torch.Generator] = None,
                   hutchinson_type: str = "rademacher", epsilon: Optional[torch.Tensor] = None,
                   prior_var: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits/dim [B], latent z) of ``data`` ([−1, 1]) by the instantaneous
    change of variables: the augmented state [x, log det] through the rows
    0 … n−1 of ``table`` (``table_loop`` under ``name``), each row's
    (t, t_next, dt) from ``times(row)``, Heun or Euler on every transition.
    ``field(fn, x, t)`` is the ODE's drift; it and the Hutchinson term εᵀJε
    of each evaluation come from one ``torch.autograd.grad`` (the JAX
    ``jax.vjp``), so ``model_fn`` must let autograd through. ``epsilon``
    injects the probe, else it is drawn from ``generator``. Prior
    N(0, prior_var·I), +7 bits for data scaled from [0, 256]."""
    if hutchinson_type not in ("rademacher", "gaussian"):
        raise ValueError("`hutchinson_type` must be one of `rademacher` or `gaussian`")
    shape = tuple(data.shape)
    B = shape[0]
    dims = tuple(range(1, len(shape)))

    def v_div(fn, x, t, probe):
        """The drift and εᵀJε from one vjp."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v = field(fn, xg, t)
            (eps_j,) = torch.autograd.grad(v, xg, grad_outputs=probe)
        return v.detach(), torch.sum(eps_j * probe, dim=dims)

    def step(fn, s, row):
        t, t_next, dt = times(row)
        x, ld, probe = s["x"], s["logdet"], s["epsilon"]
        v1, d1 = v_div(fn, x, t, probe)
        if heun:
            v2, d2 = v_div(fn, x + dt * v1, t_next, probe)
            x_n, ld_n = x + dt * 0.5 * (v1 + v2), ld + dt * 0.5 * (d1 + d2)
        else:
            x_n, ld_n = x + dt * v1, ld + dt * d1
        x.copy_(x_n)
        ld.copy_(ld_n)

    with torch.inference_mode(False), torch.no_grad():
        eps = (draw_epsilon(sampler, shape, generator, hutchinson_type) if epsilon is None
               else epsilon.to(device=data.device, dtype=torch.float32))
        state = {"x": data.to(torch.float32).clone(), "epsilon": eps.clone(),
                 "logdet": torch.zeros((B,), dtype=torch.float32, device=data.device)}
        state = table_loop(sampler, name, model_fn, params, state, table, step, n, graphs)
        z, delta = state["x"].clone(), state["logdet"].clone()
        n_dims = int(np.prod(shape[1:]))
        prior_logp = -0.5 * (torch.sum(z.reshape(B, -1) ** 2, dim=1) / prior_var
                             + n_dims * float(np.log(2.0 * np.pi * prior_var)))
        return -(prior_logp + delta) / float(np.log(2.0)) / n_dims + 7.0, z


def slerp(z1: torch.Tensor, z2: torch.Tensor, lambd: float) -> torch.Tensor:
    """Spherical interpolation at ``lambd`` between the rows of two latent
    batches, each pair's angle from its flattened rows (sin ω floored at
    1e-6)."""
    f1, f2 = z1.reshape(z1.shape[0], -1), z2.reshape(z2.shape[0], -1)
    n1 = f1 / torch.linalg.vector_norm(f1, dim=1, keepdim=True)
    n2 = f2 / torch.linalg.vector_norm(f2, dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp(torch.sum(n1 * n2, dim=1), -1.0, 1.0))[:, None]
    so = torch.clamp_min(torch.sin(omega), 1e-6)
    lam = float(lambd)
    return (torch.sin((1.0 - lam) * omega) / so * f1 + torch.sin(lam * omega) / so * f2).reshape(z1.shape)
