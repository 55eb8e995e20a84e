"""RePaint inpainting (Lugmayr et al. 2022, Algorithm 1) on any
GaussianDiffusion-family process.

Counterpart of ``diffusion_model_nemo_tpu/modules/repaint.py``: the same
host jump schedule (``repaint_schedule``) and the same two operations. A
reverse entry t denoises x_t → x_{t−1} (an ancestral step, its noise
masked at t = 0) and blends the known region, forward-noised to t − 1 (the
clean image at t = 0):

    x_{t−1} = m·q_sample(y, t − 1) + (1 − m)·p_sample(x_t, t);

a forward entry s re-noises one step, √(1 − β_s)·x + √β_s·ε. The JAX scan
picks between them with ``lax.cond``; a CUDA graph has no data-dependent
branch, and the host knows the schedule, so each is captured once (the
reverse at the first entry, the forward at the first forward entry: their
warm-ups are those entries) and the two are replayed in schedule order,
sharing static buffers and a device counter that both advance. A reverse
entry draws two noises (the step's, then the known region's), a forward
entry one, in the eager loop's order, as the JAX body splits its key;
``noise`` [N, 2, *shape] injects them. With a 0/1 mask the known region of
the result is the input exactly (the last entry blends the clean image).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import graphs as graphs_lib
from ..ops.schedules import extract
from .diffusion_process import ModelFn
from .gaussian_diffusion import _randn, fill_static, graph_key, static_model_fn

__all__ = ["repaint_schedule", "repaint_loop", "run_schedule"]


def repaint_schedule(timesteps: int, jump_length: int = 10, jump_n_sample: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """The host jump schedule (RePaint's ``get_schedule_jump``): ``(t_op,
    is_reverse)``, [N] int32 / bool. ``jump_n_sample=1`` (or
    ``jump_length=0``) is the plain reverse chain t = T−1 … 0."""
    T = int(timesteps)
    j, r = int(jump_length), int(jump_n_sample)
    if j <= 0 or r <= 1:
        t_ops = list(range(T - 1, -1, -1))
        return np.asarray(t_ops, np.int32), np.ones(len(t_ops), bool)
    # re-dos left at each jump anchor (every j levels, the top segment excluded)
    jumps = {t: r - 1 for t in range(0, T - j, j)}
    t = T
    ops = []  # (t_op, is_reverse)
    while t >= 1:
        t -= 1
        ops.append((t, True))  # reverse at t: x_t -> x_{t-1}
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(j):
                t += 1
                ops.append((t, False))  # forward: x_{t-1} -> x_t with beta_t
    t_op = np.asarray([o[0] for o in ops], np.int32)
    is_rev = np.asarray([o[1] for o in ops], bool)
    return t_op, is_rev


def _reverse(process, fn, params, s: Dict[str, torch.Tensor], t: torch.Tensor) -> None:
    """Denoise x_t → x_{t−1} and blend the known region at t − 1 (``t`` a
    0-d device tensor)."""
    x_prev = process.p_sample(fn, params, s["x"], t, noise=s["noise"])
    y_t = process.q_sample(s["y"], (t - 1).clamp_min(0), s["known_noise"])
    y_t = torch.where(t == 0, s["y"], y_t)
    s["x"].copy_(s["m"] * y_t + (1.0 - s["m"]) * x_prev)


def _forward(process, s: Dict[str, torch.Tensor], t: torch.Tensor) -> None:
    """Re-noise one step with β_t (RePaint eq. 9)."""
    b = extract(process.constants.betas, t, s["x"].ndim)
    s["x"].copy_(torch.sqrt(1.0 - b) * s["x"] + torch.sqrt(b) * s["noise"])


def repaint_loop(
    process,
    model_fn: ModelFn,
    params: Any,
    known: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    jump_length: int = 10,
    jump_n_sample: int = 10,
    unnormalize: bool = True,
    img: Optional[torch.Tensor] = None,
    graphs: Optional[bool] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inpaint ``known`` ([B, H, W, C] in [-1, 1]) where ``mask`` (broadcast
    to it; 1 = keep) is 0, from ``img`` (default N(0, I) from
    ``generator``). ``graphs``: replay the two captured steps (default: on
    CUDA) or run the Python loop; the draws are the same. Returns [B, H,
    W, C] (in [0, 1] under ``unnormalize``)."""
    t_op, is_rev = repaint_schedule(process.timesteps, jump_length, jump_n_sample)
    out = run_schedule(process, model_fn, params, known, mask, t_op, is_rev, generator, img, graphs, noise)
    return (out + 1.0) * 0.5 if unnormalize else out.clone()


def run_schedule(process, model_fn, params, known, mask, t_op: np.ndarray, is_rev: np.ndarray,
                 generator: Optional[torch.Generator] = None, img: Optional[torch.Tensor] = None,
                 graphs: Optional[bool] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``repaint_loop`` over the entries of a given schedule (a prefix of
    one, say); returns x in [-1, 1] (the graphs' static buffer on CUDA)."""
    shape = tuple(known.shape)
    N = len(t_op)
    if noise is not None and tuple(noise.shape) != (N, 2, *shape):
        raise ValueError(f"noise must be [N, 2, *shape] = {[N, 2, *shape]}, got {list(noise.shape)}")
    x = img if img is not None else _randn(shape, generator, known.device)
    state = {"x": x.clone(), "noise": torch.empty_like(x), "known_noise": torch.empty_like(x),
             "y": known.to(torch.float32).clone(),
             "m": torch.broadcast_to(mask.to(device=x.device, dtype=torch.float32), shape).clone()}

    def draw(s, i: int) -> None:
        """Entry i's noise: the step's, then (reverse) the known region's."""
        for k, buf in enumerate(("noise", "known_noise")[: 2 if is_rev[i] else 1]):
            if noise is not None:
                s[buf].copy_(noise[i, k])
            else:
                s[buf].normal_(generator=generator)

    if graphs_lib.use_graphs(graphs, x.device):
        return _repaint_replays(process, model_fn, params, state, t_op, is_rev, draw)
    t_dev = torch.as_tensor(t_op, dtype=torch.long).to(x.device)
    for i in range(N):
        draw(state, i)
        if is_rev[i]:
            _reverse(process, model_fn, params, state, t_dev[i])
        else:
            _forward(process, state, t_dev[i])
    return state["x"]


def _repaint_replays(process, model_fn, params, state, t_op, is_rev, draw) -> torch.Tensor:
    """The schedule as replays of the reverse and the forward graph, in
    order. Both read t_op at the shared counter ``i`` and advance it."""
    dev = state["x"].device
    N = len(t_op)
    base = (N, process.timesteps, np.asarray(t_op, np.int32).tobytes(), np.asarray(is_rev, bool).tobytes(),
            tuple(state["x"].shape), dev, *graph_key(model_fn))
    sources = (*(params or {}).values(), *process.table_tensors())
    static: Dict[str, Any] = {}

    def at_i():
        return static["t_op"].index_select(0, static["i"].reshape(1))[0]

    def build_reverse():
        static.update({k: v.clone() for k, v in state.items()})
        static["t_op"] = torch.as_tensor(t_op, dtype=torch.long).to(dev)
        static["i"] = torch.zeros((), dtype=torch.long, device=dev)
        fn = static_model_fn(model_fn, static)

        def step():
            _reverse(process, fn, params, static, at_i())
            static["i"].add_(1)

        def warmup():  # entry 0, always a reverse one
            draw(static, 0)
            step()

        return graphs_lib.Graph("repaint_reverse", step, static, device=dev, warmup=warmup)

    reverse, built = graphs_lib.cached(process.graphs, ("repaint_reverse", *base), sources, build_reverse)
    static = reverse.static
    if not built:
        for k, v in state.items():
            static[k].copy_(v)
        static["i"].zero_()
        fill_static(model_fn, static)
    forward = None
    for i in range(int(built), N):
        if is_rev[i]:
            draw(static, i)
            reverse.replay()
            continue
        if forward is None:
            def build_forward(i=i):
                def step():
                    _forward(process, static, at_i())
                    static["i"].add_(1)

                def warmup():  # this entry
                    draw(static, i)
                    step()

                return graphs_lib.Graph("repaint_forward", step, static, device=dev, warmup=warmup)

            # held to the reverse graph's buffers too: a new reverse graph captures a new forward one
            forward, built_f = graphs_lib.cached(process.graphs, ("repaint_forward", *base),
                                                 (*sources, static["x"]), build_forward)
            if built_f:
                continue
        draw(static, i)
        forward.replay()
    return static["x"]
