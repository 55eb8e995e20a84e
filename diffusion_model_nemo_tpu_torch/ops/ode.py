"""Adaptive Dormand–Prince RK45 with the state on the device.

Counterpart of ``diffusion_model_nemo_tpu/ops/ode.py``: the same Butcher
tableau (scipy's ``RK45``), controller constants, step clipping, accept rule
and error norm (summed over the state's leaves in order), NFE counted as 7
a step, and NaN-poisoning when ``max_steps`` runs out. The JAX package runs
the solve as one ``lax.while_loop``, whose trip count depends on the data.
Here one RK step (seven evaluations, the error norm, the accept
``torch.where``; t, h, NFE, the step count and ``done`` as device tensors)
is the unit: a step taken after ``done`` (or after ``max_steps``) leaves the
state as it was, so the host reads ``done`` only every ``CHECK_EVERY``
replays and a few extra steps give what the JAX loop gives. With ``graphs``
the step is captured once as a CUDA graph (``graphs.py``) and replayed; on
the CPU the "replay" calls the same step function, so the eager and the
replayed loops agree bit for bit.

The state ``y`` is a tensor or a tuple of tensors (the likelihood's
(x, logp)). ``func(t, y)`` returns dy/dt of the same structure (``t`` a
0-d float32 tensor); with ``inputs`` it is called as ``func(t, y,
inputs)``, and a captured solve passes its own copies of ``inputs``
(static buffers, refilled before every solve), so that ``func`` must read
its per-solve tensors from there.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import graphs as graphs_lib

__all__ = ["odeint_rk45", "ODESolution", "poison_on_failure", "rk45_init", "rk45_step"]

log = logging.getLogger(__name__)

# Dormand–Prince 5(4) (scipy's RK45), as the JAX package holds it: _A as
# Python floats, _C, _B5 and _B4 as float32 arrays and _ERR = _B5 - _B4 in
# float32. A Python float times a float32 tensor is the float32 product.
_C = [float(c) for c in np.asarray([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)]
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5_32 = np.asarray([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], np.float32)
_B4_32 = np.asarray([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
                    np.float32)
_B5 = [float(b) for b in _B5_32]
_ERR = [float(e) for e in (_B5_32 - _B4_32)]

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
ORDER = 5.0
_NEG_INV_ORDER = float(np.float32(-1.0 / ORDER))  # the exponent as a float32, as XLA holds it
CHECK_EVERY = 8  # steps between the host's reads of ``done`` on the captured path


class ODESolution(NamedTuple):
    y: Any  # final state (a tensor or a tuple of tensors)
    nfev: torch.Tensor  # 0-d int32: function evaluations
    success: torch.Tensor  # 0-d bool: t1 reached before max_steps


def _leaves(y) -> list:
    return list(y) if isinstance(y, (tuple, list)) else [y]


def _like(y0, leaves: Sequence[torch.Tensor]):
    return tuple(leaves) if isinstance(y0, (tuple, list)) else leaves[0]


def _combine(y, h, coeffs, ks):
    """Per leaf: y + h·Σ c·k (the terms summed in order from 0, as the JAX
    package's Python ``sum`` adds them)."""
    out = []
    for j, y_ in enumerate(y):
        acc = 0
        for c, k in zip(coeffs, ks):
            acc = acc + c * k[j]
        out.append(y_ + h * acc)
    return out


def _error_norm(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    """RMS of err / (atol + rtol·max(|y0|, |y1|)) over every element of
    every leaf."""
    total = 0.0
    n = 0
    for e, a, b in zip(err, y0, y1):
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        r = (e / scale).to(torch.float32)
        total = total + torch.sum(r * r)
        n += int(e.numel())
    return torch.sqrt(total / n)


def rk45_init(y0, t0: float, t1: float, first_step: float = 1e-3, device=None) -> Dict[str, Any]:
    """The solver's state: t, h, NFE, step count, done, y (leaves, copied)."""
    leaves = _leaves(y0)
    device = device or leaves[0].device
    t0_, t1_ = np.float32(t0), np.float32(t1)
    direction = np.sign(np.float32(t1_ - t0_))
    state = {
        "t": torch.tensor(t0_, dtype=torch.float32, device=device),
        "h": torch.tensor(np.float32(direction * abs(np.float32(first_step))), dtype=torch.float32, device=device),
        "nfe": torch.zeros((), dtype=torch.int32, device=device),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "done": torch.zeros((), dtype=torch.bool, device=device),
        "y": [leaf.detach().clone() for leaf in leaves],
        "single": not isinstance(y0, (tuple, list)),
    }
    return state


def rk45_reset(state: Dict[str, Any], y0, t0: float, first_step: float, t1: float) -> None:
    """Put a state back at (t0, y0) in place (a captured solve's buffers)."""
    direction = np.sign(np.float32(np.float32(t1) - np.float32(t0)))
    state["t"].fill_(float(np.float32(t0)))
    state["h"].fill_(float(np.float32(direction * abs(np.float32(first_step)))))
    state["nfe"].zero_()
    state["step"].zero_()
    state["done"].fill_(False)
    for dst, src in zip(state["y"], _leaves(y0)):
        dst.copy_(src)


def rk45_step(func: Callable, state: Dict[str, Any], t0: float, t1: float, rtol: float, atol: float,
              max_steps: int) -> None:
    """One step of the JAX loop's body, in place; a no-op once ``done`` or
    after ``max_steps`` steps (the JAX loop's ``cond``)."""
    t, y = state["t"], state["y"]
    t1_ = float(np.float32(t1))
    direction = float(np.sign(np.float32(np.float32(t1) - np.float32(t0))))
    active = torch.logical_and(torch.logical_not(state["done"]), state["step"] < max_steps)
    # Clip the step so as not to overshoot t1.
    h = torch.where(direction * (t + state["h"] - t1_) > 0, t1_ - t, state["h"])
    ks = [_leaves(func(t, _like_state(state, y)))]
    for i in range(1, 7):
        y_i = _combine(y, h, _A[i], ks)
        ks.append(_leaves(func(t + _C[i] * h, _like_state(state, y_i))))
    y1 = _combine(y, h, _B5, ks)
    err = []
    for j in range(len(y)):
        acc = 0
        for e, k in zip(_ERR, ks):
            acc = acc + e * k[j]
        err.append(h * acc)
    enorm = _error_norm(err, y, y1, rtol, atol)
    accept = enorm <= 1.0
    # enorm^(-1/5) rounded from float64: XLA's float32 pow is (nearly)
    # correctly rounded, torch's float32 pow is an ulp off in ~2% of values.
    power = (enorm.double() ** _NEG_INV_ORDER).to(torch.float32)
    factor = torch.where(enorm == 0.0, torch.full_like(enorm, MAX_FACTOR),
                         torch.clamp(SAFETY * power, MIN_FACTOR, MAX_FACTOR))
    h_next = h * factor
    t_new = torch.where(accept, t + h, t)
    keep = torch.logical_and(active, accept)
    for dst, new in zip(y, y1):
        dst.copy_(torch.where(keep, new, dst))
    reached = direction * (t_new - t1_) >= 0
    state["done"].copy_(torch.where(active, reached, state["done"]))
    state["h"].copy_(torch.where(active, h_next, state["h"]))
    t.copy_(torch.where(active, t_new, t))
    state["nfe"].add_(active.to(torch.int32) * 7)
    state["step"].add_(active.to(torch.int32))


def _like_state(state, leaves):
    """The leaves in the structure of the solve's ``y0``."""
    return leaves[0] if state["single"] else tuple(leaves)


def _finished(state, max_steps: int) -> bool:
    return bool(torch.logical_or(state["done"], state["step"] >= max_steps))


def odeint_rk45(
    func: Callable,
    y0: Any,
    t0: float,
    t1: float,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 10_000,
    first_step: float = 1e-3,
    *,
    inputs: Optional[Dict[str, torch.Tensor]] = None,
    graphs: bool = False,
    store: Optional[dict] = None,
    key: tuple = (),
    sources: Sequence[torch.Tensor] = (),
) -> ODESolution:
    """Integrate dy/dt = func(t, y) from ``t0`` to ``t1`` (either direction).

    ``graphs``: replay one captured step (kept in ``store`` under ``key``,
    held to ``sources``, the parameters ``func`` reads), reading ``done``
    every ``CHECK_EVERY`` replays; otherwise the step runs eagerly and the
    host reads ``done`` after every step.
    Returns the final state, the NFE and the success flag (device tensors,
    copies)."""
    single = not isinstance(y0, (tuple, list))
    call = (lambda t, y, _inp: func(t, y)) if inputs is None else func
    args = (t0, t1, rtol, atol, max_steps)
    if not graphs:
        state = rk45_init(y0, t0, t1, first_step)
        while not _finished(state, max_steps):
            rk45_step(lambda t, y: call(t, y, inputs), state, *args)
    else:
        if store is None:
            raise ValueError("a captured solve needs a graph store")
        leaves = _leaves(y0)
        device = leaves[0].device

        def build():
            static = rk45_init(y0, t0, t1, first_step, device)
            static["inputs"] = {k: v.clone() for k, v in (inputs or {}).items()}

            def step():
                rk45_step(lambda t, y: call(t, y, static["inputs"]), static, *args)

            return graphs_lib.Graph("rk45", step, static, device=device, warmup=step)

        gkey = ("rk45", *key, args, float(first_step), single,
                tuple((tuple(v.shape), v.dtype) for v in leaves),
                tuple((k, tuple(v.shape), v.dtype) for k, v in sorted((inputs or {}).items())))
        graph, built = graphs_lib.cached(store, gkey, sources, build)
        state = graph.static
        if not built:
            rk45_reset(state, y0, t0, first_step, t1)
            for k, v in (inputs or {}).items():
                state["inputs"][k].copy_(v)
        while not _finished(state, max_steps):
            graph.replay(CHECK_EVERY)
    y = _like(y0, [leaf.clone() for leaf in state["y"]])
    return ODESolution(y=y, nfev=state["nfe"].clone(), success=state["done"].clone())


def poison_on_failure(sol: ODESolution, tree: Any, what: str) -> Any:
    """``tree`` with its float leaves NaN where the solver ran out of
    ``max_steps`` (the last iterate is no solution), and a warning."""
    if not bool(sol.success):
        log.warning(f"RK45 exhausted max_steps before reaching t1 during {what}; results are NaN-poisoned "
                    "(raise max_steps or loosen rtol/atol)")

    def poison(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return torch.where(sol.success, a, torch.full_like(a, float("nan")))
        return a

    if isinstance(tree, (tuple, list)):
        return type(tree)(poison(a) for a in tree)
    return poison(tree)
