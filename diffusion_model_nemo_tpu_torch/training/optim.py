"""Optimizer and learning-rate schedule from ``cfg.optim``.

Counterpart of ``diffusion_model_nemo_tpu/training/optim.py``, which chains
optax's ``clip_by_global_norm`` and ``adamw`` (or ``adam`` / ``sgd``). The
update is written out to follow optax step for step, where torch's own
optimizer and clip differ:
- clipping is ``g · max / ‖g‖`` only when ‖g‖ ≥ max (torch's
  ``clip_grad_norm_`` divides by ‖g‖ + 1e-6 always);
- the schedule is read at the count of completed updates, so the first
  update uses lr(0);
- AdamW decays every leaf (optax's ``adamw`` has no mask here), biases and
  norm parameters included: u = -lr · (m̂ / (√v̂ + eps) + wd · p);
- SGD's update is -lr · trace, added to the parameters (optax's
  ``scale_by_learning_rate`` then ``apply_updates``: two roundings).
Parameters and state are dicts of float32 tensors keyed like ``state_dict``.

The scalars that change with the step (-lr and the two bias corrections;
optax keeps its ``count`` on the device) come from a float32 table over
counts 0 … n (``Optimizer.table``, built on the host with the Python
arithmetic optax's schedule and corrections use): each update reads its
row, a [3] tensor on the device, so that a captured training step
(``ops/graphs.py``) reads each replay's own from a static buffer. On CUDA
ATen divides by a Python float as a multiplication by its reciprocal, taken
in double and rounded to float32 (measured on the H100 with torch 2.11), so
a CUDA table holds that reciprocal and multiplies; the CPU divides. Either
way the update has the bits of one computed with Python-float scalars
(tests/test_torch_port_graphs_training.py on the CPU, chip_smoke phase 9 on
the card).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["Optimizer", "build_lr_schedule", "build_optimizer", "clip_by_global_norm", "global_norm"]

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


def build_lr_schedule(optim_cfg: Mapping[str, Any], max_steps: int) -> Schedule:
    """``CosineAnnealing`` (optax ``cosine_decay_schedule`` with
    alpha = min_lr / lr, after an optional linear warm-up joined at
    ``warmup_steps``) or a constant; ``step`` counts completed updates."""
    lr = float(optim_cfg.get("lr", 1e-3))
    sched_cfg = optim_cfg.get("sched") or {}
    name = (sched_cfg.get("name") or "none").lower()
    if name in ("none", "null"):
        return lambda step: lr
    if name not in ("cosineannealing", "warmupannealing", "cosine"):
        raise ValueError(f"Unknown LR schedule `{sched_cfg.get('name')}`")
    warmup_steps = sched_cfg.get("warmup_steps")
    warmup_ratio = sched_cfg.get("warmup_ratio")
    if warmup_steps is None and warmup_ratio is not None:
        warmup_steps = int(float(warmup_ratio) * max_steps)
    warmup_steps = int(warmup_steps or 0)
    min_lr = float(sched_cfg.get("min_lr", 0.0) or 0.0)
    alpha = min_lr / lr if lr > 0 else 0.0
    decay_steps = max(max_steps - warmup_steps, 1)

    def cosine(count: int) -> float:
        count = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)

    if warmup_steps <= 0:
        return cosine

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * min(step, warmup_steps) / warmup_steps
        return cosine(step - warmup_steps)

    return schedule


def global_norm(grads: Params) -> torch.Tensor:
    """√(Σ ‖g‖²) over every leaf, as a float32 0-d tensor (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))


def clip_by_global_norm(grads: Params, max_norm: float, norm: Optional[torch.Tensor] = None) -> Params:
    """optax ``clip_by_global_norm``: g where ‖g‖ < max, else (g / ‖g‖) · max
    (the norm stays on the device: no host sync)."""
    norm = global_norm(grads) if norm is None else norm
    keep, one = norm < max_norm, torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    keys = list(grads)
    return dict(zip(keys, torch._foreach_mul(torch._foreach_div([grads[k] for k in keys], div), mul)))


class Optimizer:
    """AdamW / Adam / SGD(momentum) over a dict of float32 tensors, updated
    in place with multi-tensor ops. ``state`` holds the moments and the
    count of completed updates (a host int: what checkpoints store)."""

    def __init__(self, name: str, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, momentum: float = 0.0,
                 grad_clip: Optional[float] = None):
        if name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"Unknown optimizer `{name}`")
        self.name, self.schedule = name, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay if name == "adamw" else 0.0
        self.momentum, self.grad_clip = momentum, grad_clip

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        if self.name == "sgd":
            return {"count": 0, "trace": zeros}
        return {"count": 0, "mu": zeros, "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """(-lr, 1 - b1^(count+1), 1 - b2^(count+1)) for the update after
        ``count`` completed ones, as Python floats."""
        return -self.schedule(count), 1.0 - self.b1 ** (count + 1), 1.0 - self.b2 ** (count + 1)

    def table(self, n: int, device) -> torch.Tensor:
        """[n + 1, 3] float32 on ``device``: ``scalars(count)`` for count =
        0 … n, the bias corrections as their reciprocals on CUDA (see the
        module note). Row ``count`` is the ``scalars`` of ``step``."""
        rows = np.array([self.scalars(c) for c in range(n + 1)], dtype=np.float64)
        if torch.device(device).type == "cuda":
            rows[:, 1:] = 1.0 / rows[:, 1:]
        return torch.from_numpy(rows.astype(np.float32)).to(device)

    def step(self, params: Params, grads: Params, state: Dict[str, Any],
             grad_norm: Optional[torch.Tensor] = None, *, scalars: torch.Tensor) -> None:
        """Clip (if set; ``grad_norm`` is ‖grads‖ where the caller has it),
        then one update of ``params`` in place with ``scalars``, the row of
        ``table`` at ``state["count"]`` on the parameters' device. The caller
        advances ``state["count"]`` (a captured step cannot)."""
        if self.grad_clip is not None and self.grad_clip > 0:
            grads = clip_by_global_norm(grads, float(self.grad_clip), grad_norm)
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        neg_lr, bc1, bc2 = scalars.unbind()
        if self.name == "sgd":
            tr = [state["trace"][k] for k in keys]
            torch._foreach_mul_(tr, self.momentum)
            torch._foreach_add_(tr, g)
            torch._foreach_add_(p, torch._foreach_mul(tr, neg_lr))
            return
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        # optax update_moment: (1 - b) · g^k + b · m
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        mu_hat = _bias_correct(mu, bc1)
        nu_hat = _bias_correct(nu, bc2)
        upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_add_(p, torch._foreach_mul(upd, neg_lr))


def _bias_correct(xs, bc):
    """xs / bc: the division on the CPU, the product with the stored
    reciprocal on CUDA (see the module note)."""
    if bc.device.type == "cuda":
        return torch._foreach_mul(xs, bc)
    return torch._foreach_div(xs, bc)


def build_optimizer(
    optim_cfg: Optional[Mapping[str, Any]], max_steps: int, grad_clip: Optional[float] = 1.0
) -> Tuple[Optimizer, Schedule]:
    """The optimizer (with the global-norm clip in front) and its schedule."""
    optim_cfg = optim_cfg or {"name": "adamw", "lr": 1e-3}
    name = str(optim_cfg.get("name", "adamw")).lower()
    schedule = build_lr_schedule(optim_cfg, max_steps)
    betas = optim_cfg.get("betas", (0.9, 0.999))
    opt = Optimizer(
        name, schedule, b1=float(betas[0]), b2=float(betas[1]),
        eps=float(optim_cfg.get("eps", 1e-8)),
        weight_decay=float(optim_cfg.get("weight_decay", 0.0)),
        momentum=float(optim_cfg.get("momentum", 0.0)),
        grad_clip=grad_clip,
    )
    return opt, schedule
