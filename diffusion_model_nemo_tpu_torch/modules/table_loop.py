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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import graphs as graphs_lib
from .gaussian_diffusion import fill_static, graph_key, put_frame, static_model_fn

__all__ = ["device_table", "table_loop"]

Step = Callable[[Any, Dict[str, torch.Tensor], torch.Tensor], None]


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
