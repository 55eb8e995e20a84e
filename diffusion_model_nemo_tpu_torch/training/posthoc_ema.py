"""Post-hoc EMA: power-function parameter averages whose profile is chosen
after training (Karras et al. 2024, "Analyzing and Improving the Training
Dynamics of Diffusion Models", §3 and App. B).

Counterpart of ``diffusion_model_nemo_tpu/training/posthoc_ema.py``. During
training each tracked average with exponent γ follows

    beta(t) = (1 − 1/t)^(γ + 1),   ema ← beta·ema + (1 − beta)·params

at t = 1, 2, … completed optimizer steps (beta is 0 at t = 1, so the state
starts as a copy of the parameters); beta is computed as
``exp((γ+1)·log1p(−1/t))`` in float32, on the device, as the JAX package does.
Each average is written every ``every_n_steps`` steps as
``phema-{γ:.6f}-{t:010d}.msgpack``: the flax parameter tree in flax's
msgpack layout (``utils/weights.py``, ``utils/msgpack.py``), so that either
package reads the other's snapshots. ``reconstruct`` solves the least-squares
combination of the snapshots for any target profile (γ or σ_rel, and t) with
the closed-form Gram matrix of the profiles, on the host in float64 numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import msgpack
from ..utils.weights import to_flax_params

__all__ = [
    "sigma_rel_to_gamma",
    "gamma_to_sigma_rel",
    "power_ema_beta",
    "power_ema_update",
    "profile_dot",
    "solve_posthoc_weights",
    "PostHocEMA",
    "list_snapshots",
    "reconstruct",
]


# --------------------------------------------------------------- profiles ----
def gamma_to_sigma_rel(gamma: float) -> float:
    """σ_rel of the s^γ profile: σ_rel² = (γ+1) / ((γ+2)² (γ+3))."""
    g = float(gamma)
    return float(np.sqrt((g + 1.0) / ((g + 2.0) ** 2 * (g + 3.0))))


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """The inverse: the largest real root of γ³ + 7γ² + (16 − σ⁻²)γ + (12 −
    σ⁻²) = 0 (the other two are below −1)."""
    s = float(sigma_rel)
    if not 0.0 < s < gamma_to_sigma_rel(0.0):
        raise ValueError(
            f"sigma_rel must be in (0, {gamma_to_sigma_rel(0.0):.4f}) "
            f"(gamma=0 is the flat/uniform profile); got {s}"
        )
    t = s**-2
    roots = np.roots([1.0, 7.0, 16.0 - t, 12.0 - t])
    return float(np.max(roots.real))


def power_ema_beta(gamma: float, t: torch.Tensor) -> torch.Tensor:
    """beta(t) = (1 − 1/t)^(γ+1) as exp((γ+1)·log1p(−1/t)), float32 (``t``
    a tensor of completed steps, clamped at 1)."""
    t = torch.clamp(t.to(torch.float32), min=1.0)
    return torch.exp((float(gamma) + 1.0) * torch.log1p(-1.0 / t))


def power_ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], gamma: float,
                     t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One online step of the average at profile time ``t`` (completed
    optimizer steps, 1-based), in place: ema·beta + params·(1 − beta), a
    few multi-tensor launches for the whole tree."""
    beta = power_ema_beta(gamma, t)
    keys = list(ema)
    trees = [ema[k] for k in keys]
    with torch.no_grad():
        torch._foreach_mul_(trees, beta)
        torch._foreach_add_(trees, torch._foreach_mul([params[k].detach().to(ema[k].dtype) for k in keys],
                                                      1.0 - beta))
    return ema


def profile_dot(t_a, gamma_a, t_b, gamma_b) -> np.ndarray:
    """The inner product of two normalised power profiles p_{γ,t}(s) = (γ+1)
    s^γ / t^(γ+1) on [0, min(t_a, t_b)], in log space, float64, broadcast:
    (γa+1)(γb+1) min^(γa+γb+1) / ((γa+γb+1) ta^(γa+1) tb^(γb+1))."""
    ta, tb = np.asarray(t_a, np.float64), np.asarray(t_b, np.float64)
    ga, gb = np.asarray(gamma_a, np.float64), np.asarray(gamma_b, np.float64)
    log_val = (ga + gb + 1.0) * np.log(np.minimum(ta, tb)) - (ga + 1.0) * np.log(ta) - (gb + 1.0) * np.log(tb)
    return (ga + 1.0) * (gb + 1.0) / (ga + gb + 1.0) * np.exp(log_val)


def solve_posthoc_weights(ts: Sequence[float], gammas: Sequence[float], t_target: float,
                          gamma_target: float) -> np.ndarray:
    """The least-squares weights x of the snapshots' profiles for the target
    profile: A x = b with A_ij = <p_i, p_j>, b_i = <p_i, p_r> (the
    minimum-norm solution when A is singular)."""
    ts, gs = np.asarray(ts, np.float64), np.asarray(gammas, np.float64)
    A = profile_dot(ts[:, None], gs[:, None], ts[None, :], gs[None, :])
    b = profile_dot(ts, gs, np.float64(t_target), np.float64(gamma_target))
    try:
        return np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(A, b, rcond=None)[0]


# --------------------------------------------------------------- training ----
class PostHocEMA:
    """The tracked averages of one run: ``init_state`` copies the parameters
    once per σ_rel, ``update`` advances them in place, ``snapshot`` writes
    them (as flax trees of ``network``'s layout)."""

    def __init__(self, directory: str, sigma_rels: Sequence[float] = (0.05, 0.10), every_n_steps: int = 1024,
                 network: Optional[torch.nn.Module] = None):
        if not sigma_rels:
            raise ValueError("sigma_rels must be non-empty")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.sigma_rels = tuple(float(s) for s in sigma_rels)
        self.gammas = tuple(sigma_rel_to_gamma(s) for s in self.sigma_rels)
        self.every = int(every_n_steps)
        self.network = network

    def init_state(self, params: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        return [{k: v.detach().clone() for k, v in params.items()} for _ in self.gammas]

    def update(self, state: List[Dict[str, torch.Tensor]], params: Dict[str, torch.Tensor],
               t: torch.Tensor) -> None:
        """Advance every average to profile time ``t`` (the completed
        optimizer steps: a device tensor, so that a captured step reads it
        from a static buffer)."""
        for tree, g in zip(state, self.gammas):
            power_ema_update(tree, params, g, t)

    def snapshot(self, state: List[Dict[str, torch.Tensor]], t: int) -> List[Path]:
        paths = []
        for gamma, tree in zip(self.gammas, state):
            host = {k: v.detach().cpu() for k, v in tree.items()}
            p = self.dir / f"phema-{gamma:.6f}-{int(t):010d}.msgpack"
            p.write_bytes(msgpack.packb(to_flax_params(host, self.network)))
            paths.append(p)
        return paths

    def maybe_snapshot(self, state: List[Dict[str, torch.Tensor]], t: int) -> None:
        if self.every > 0 and t > 0 and t % self.every == 0:
            self.snapshot(state, t)


# ---------------------------------------------------------- reconstruction ----
def list_snapshots(directory: str) -> List[Tuple[float, int, Path]]:
    """The snapshot files of ``directory`` as [(γ, t, path)], by t then γ."""
    out = []
    for p in Path(directory).glob("phema-*-*.msgpack"):
        try:
            _, gamma_s, t_s = p.stem.split("-")
            out.append((float(gamma_s), int(t_s), p))
        except ValueError:
            continue
    return sorted(out, key=lambda x: (x[1], x[0]))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def reconstruct(directory: str, sigma_rel: Optional[float] = None, gamma: Optional[float] = None,
                t: Optional[int] = None) -> Any:
    """The average for a target profile (exactly one of ``sigma_rel`` and
    ``gamma``; ``t`` defaults to the latest snapshot's) from the snapshots
    of ``directory``: a flax tree of float32 numpy arrays, summed in
    float64."""
    if (sigma_rel is None) == (gamma is None):
        raise ValueError("pass exactly one of sigma_rel / gamma")
    gamma_r = sigma_rel_to_gamma(sigma_rel) if gamma is None else float(gamma)
    snaps = list_snapshots(directory)
    if not snaps:
        raise FileNotFoundError(f"no phema-*.msgpack snapshots in {directory}")
    t_r = float(t if t is not None else max(s[1] for s in snaps))
    weights = solve_posthoc_weights([s[1] for s in snaps], [s[0] for s in snaps], t_r, gamma_r)
    acc = None
    for (_g, _ti, path), w in zip(snaps, weights):
        scaled = _tree_map(lambda x: np.asarray(x, np.float64) * w, msgpack.unpackb(path.read_bytes()))
        acc = scaled if acc is None else _tree_map(np.add, acc, scaled)
    return _tree_map(lambda x: np.asarray(x, np.float32), acc)
