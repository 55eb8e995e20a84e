"""Consistency distillation and training (Song et al. 2023) of a DDPM-family
teacher into a one-to-few-step student.

Counterpart of ``diffusion_model_nemo_tpu/training/consistency.py``. CD
(Algorithm 2, ``mode="distill"``): data x₀ and a grid transition
σ_lo < σ_hi (n ~ U{0, …, N − 2}, σ_hi = σ_n, σ_lo = σ_{n+1}); x̂_hi = x₀ +
σ_hi·z; one teacher Heun (or Euler) step down to σ_lo; the student's head
at (x̂_hi, σ_hi) regresses the EMA target network's head at the teacher's
(x̂_lo, σ_lo). CT (Algorithm 3, ``mode="train"``): x̂_lo = x₀ + σ_lo·z with
the same z, no teacher call. The head is ``ConsistencySampler.
consistency_fn`` at one step and without the clip; the training grid is a
separate ``KarrasDiffusion`` of ``grid_steps`` levels (its float conditioning
times off the integer grid, unrounded). Losses: ``l2``, and ``pseudo_huber``
√(‖d‖² + c²) − c with c = 0.00054·√D.

A step is one device program, as the JAX package's one jitted dispatch:
the teacher's step (no autograd), the target's head, the student's head,
loss and backward, the global-norm clip, AdamW at optax's default betas
with a constant rate, then θ⁻ ← μθ⁻ + (1 − μ)θ, in place. The σ and time
tables [N] are gathered with [B] index tensors; the head's coefficients
are float32 around the network. On CUDA the step is one captured graph
(``distillation.py:FusedStep``): the batch's arrays, the flip mask, n, z
and the optimizer's row are static buffers, and the target's tensors are among the
graph's writes. The draws are injected or drawn from a ``torch.Generator``
(the JAX step splits its key inside the jit: the streams differ).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config.yaml_config import from_dict
from ..data.hf_vision_data import preprocess_batch
from ..modules.consistency_sampler import ConsistencySampler
from ..modules.karras_diffusion import KarrasDiffusion
from ..modules.parts import not_ported
from .distillation import FusedStep, Params, _col, _student, network_out, predict_eps_x0

__all__ = ["ConsistencyDistiller", "ConsistencyState"]


@dataclass
class ConsistencyState:
    """A run's teacher (read only), its student (updated in place), the EMA
    target, the student's optimizer state and the captured step."""

    teacher: Params
    student: Params
    target: Params
    opt_state: Dict
    graphs: Dict[tuple, Any] = field(default_factory=dict)


class ConsistencyDistiller(FusedStep):
    """Consistency distillation over a DDPM-family model (its ``params``
    are the teacher). ``grid_steps``: N levels of the training grid (Karras
    ρ-spacing over the teacher's schedule, endpoints its own unless
    ``sigma_min`` / ``sigma_max``); ``sigma_data``: the head's σ_d;
    ``ema_decay``: μ of the target; ``loss``: ``l2`` or ``pseudo_huber``;
    ``teacher_order``: 2 (Heun) or 1 (Euler); ``mode``: ``distill`` (CD) or
    ``train`` (CT). ``mesh=`` is not ported."""

    def __init__(self, model, grid_steps: int = 18, rho: float = 7.0, sigma_min: Optional[float] = None,
                 sigma_max: Optional[float] = None, sigma_data: float = 0.5, ema_decay: float = 0.95,
                 learning_rate: float = 1e-4, weight_decay: float = 0.0, grad_clip: float = 1.0, loss: str = "l2",
                 teacher_order: int = 2, mode: str = "distill", mesh=None):
        if mesh is not None:
            raise not_ported("ConsistencyDistiller", "mesh=", "parallelism")
        if loss not in ("l2", "pseudo_huber"):
            raise ValueError(f"unknown loss {loss!r}")
        if teacher_order not in (1, 2):
            raise ValueError(f"teacher_order must be 1 or 2, got {teacher_order}")
        if grid_steps < 2:
            raise ValueError(f"grid_steps must be >= 2, got {grid_steps}")
        if mode not in ("distill", "train"):
            raise ValueError(f"mode must be distill|train, got {mode!r}")
        self.mode = mode
        self.model = model
        self.timesteps = int(model.timesteps)
        self.teacher_objective = str(model.sampler.objective)
        self.grid_steps = int(grid_steps)
        self.rho = float(rho)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.sigma_data = float(sigma_data)
        self.ema_decay = float(ema_decay)
        self.loss_kind = loss
        self.teacher_order = int(teacher_order)
        # The packaged sampler's head, unclipped (a consistency model clips
        # only when it samples).
        self._head = self._make_sampler(sample_steps=1)
        self._head.clip_denoised = False
        sig, t_cond = self._grid_tables()
        self._sig = torch.tensor(sig, dtype=torch.float32, device=model.device)
        self._t = torch.tensor(t_cond, dtype=torch.float32, device=model.device)
        self._init_optimizer(learning_rate, weight_decay, grad_clip)

    def _sampler_cfg(self) -> Dict[str, Any]:
        scfg = self.model.cfg.get("sampler", {})
        return {"timesteps": self.timesteps, "schedule_name": scfg.get("schedule_name", "linear"),
                "schedule_cfg": scfg.get("schedule_cfg"), "rho": self.rho, "sigma_min": self.sigma_min,
                "sigma_max": self.sigma_max, "device": self.model.device}

    def _make_sampler(self, sample_steps: int) -> ConsistencySampler:
        return ConsistencySampler(objective=self.teacher_objective, sample_steps=sample_steps,
                                  sigma_data=self.sigma_data, **self._sampler_cfg())

    def _grid_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """The training grid's N descending σ and conditioning times (float64):
        a Karras grid of ``grid_steps`` levels, not the head's own."""
        kd = KarrasDiffusion(solver_steps=self.grid_steps, grid="karras", **self._sampler_cfg())
        sig, t_cond = kd._sigma_grid()
        return np.asarray(sig[:-1], np.float64), np.asarray(t_cond[:-1], np.float64)

    # ---- the teacher's ODE step ---------------------------------------------------
    def teacher_heun_step(self, teacher_fn, teacher_params: Params, xhat_hi: torch.Tensor, sig_hi: torch.Tensor,
                          t_hi: torch.Tensor, sig_lo: torch.Tensor, t_lo: torch.Tensor) -> torch.Tensor:
        """One per-sample Heun (``teacher_order`` 2) or Euler step σ_hi → σ_lo
        in x̂ coordinates; ``sig_*`` / ``t_*`` are [B]."""
        ndim = xhat_hi.ndim

        def slope(xhat, sig, t):
            a = _col(1.0 / torch.sqrt(1.0 + sig * sig), ndim)
            x_net = a * xhat
            out = network_out(teacher_fn, teacher_params, x_net, t.to(torch.float32))
            _, x0 = predict_eps_x0(self.teacher_objective, out, x_net, a, _col(sig, ndim) * a)
            return (xhat - x0.clamp(-1.0, 1.0)) / _col(sig, ndim)

        dt = _col(sig_lo - sig_hi, ndim)
        d1 = slope(xhat_hi, sig_hi, t_hi)
        x_e = xhat_hi + dt * d1
        if self.teacher_order == 1:
            return x_e
        d2 = slope(x_e, sig_lo, t_lo)
        return xhat_hi + dt * 0.5 * (d1 + d2)

    # ---- the fused step -------------------------------------------------------------
    def init_state(self, teacher: Optional[Params] = None) -> ConsistencyState:
        """A run from ``teacher`` (default the model's parameters): the
        student and the target copies of it, a fresh optimizer state."""
        teacher = self.model.params if teacher is None else teacher
        student = {k: v.detach().clone().requires_grad_(True) for k, v in teacher.items()}
        target = {k: v.detach().clone() for k, v in teacher.items()}
        return ConsistencyState(teacher, student, target, self.optimizer.init(student))

    def draw_inputs(self, state: ConsistencyState, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """A step's draws for a batch of ``shape``: the flip mask, the
        transition n ~ U{0, …, N − 2} (int32) and z."""
        B, dev = int(shape[0]), self.model.device
        return {"flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
                "n": torch.randint(0, self.grid_steps - 1, (B,), generator=generator, device=dev).to(torch.int32),
                "z": torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32)}

    def loss(self, state: ConsistencyState, batch, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The student's head against the target's head one transition
        lower; autograd to the student."""
        model, head = self.model, self._head
        proc = preprocess_batch(batch, model.device, flip=draws["flip"])
        x0_data, z = proc["pixel_values"], draws["z"]
        ndim = x0_data.ndim
        n = draws["n"].long()
        sig_hi, sig_lo = self._sig.index_select(0, n), self._sig.index_select(0, n + 1)
        t_hi, t_lo = self._t.index_select(0, n), self._t.index_select(0, n + 1)
        xhat_hi = x0_data + _col(sig_hi, ndim) * z
        fn = model.get_model_fn(proc, training=True)  # no dropout masks, no label mask: deterministic
        with torch.no_grad():
            if self.mode == "train":  # CT: the same z one level lower
                xhat_lo = x0_data + _col(sig_lo, ndim) * z
            else:
                xhat_lo = self.teacher_heun_step(fn, state.teacher, xhat_hi, sig_hi, t_hi, sig_lo, t_lo)
            f_tgt = head.consistency_fn(fn, state.target, xhat_lo, _col(sig_lo, ndim), t_lo)
        f_stu = head.consistency_fn(fn, state.student, xhat_hi, _col(sig_hi, ndim), t_hi)
        if self.loss_kind == "pseudo_huber":
            c = 0.00054 * np.sqrt(float(np.prod(x0_data.shape[1:])))
            per = torch.sqrt(torch.sum((f_stu - f_tgt) ** 2, dim=tuple(range(1, ndim))) + c * c) - c
            return torch.mean(per)
        return torch.mean((f_stu - f_tgt) ** 2)

    def _step(self, state: ConsistencyState, batch, draws, scalars: torch.Tensor) -> torch.Tensor:
        """The step itself, device work only (the captured function): the
        loss, the student's update, then the target's EMA."""
        loss = self.loss(state, batch, draws)
        self._update(state.student, loss, state.opt_state, scalars)
        with torch.no_grad():
            keys = list(state.target)
            target = [state.target[k] for k in keys]
            torch._foreach_mul_(target, self.ema_decay)
            torch._foreach_add_(target, torch._foreach_mul([state.student[k] for k in keys], 1.0 - self.ema_decay))
        return loss.detach()

    def train_step(self, state: ConsistencyState, batch, draws: Dict[str, torch.Tensor],
                   graphs: Optional[bool] = None) -> torch.Tensor:
        """One update of ``state`` (student and target) on a raw batch with
        the step's draws (``draw_inputs``'). ``graphs``: replay the captured
        step (default: on CUDA) or run it eagerly; the same numbers."""
        writes = [*state.student.values(), *state.target.values(),
                  *(v for d in ("mu", "nu") for v in state.opt_state[d].values())]
        key = ("consistency_step", self.mode, self.teacher_order, self.loss_kind)
        return self._run_step(state, key, batch, draws, graphs, lambda b, d, s: self._step(state, b, d, s), writes,
                              [*state.teacher.values(), self._sig, self._t])

    def distill(self, batches: Iterator, steps: int, generator: Optional[torch.Generator] = None,
                log_every: int = 50, draws: Optional[Iterable] = None,
                graphs: Optional[bool] = None) -> Tuple[Params, List[float]]:
        """``steps`` updates, student and target from the teacher; the draws
        from ``generator`` (default seeded 0) or the next of ``draws``.
        Returns (the student's parameters, the losses logged every
        ``log_every`` steps and at the last)."""
        draws = iter(draws) if draws is not None else None
        return self._steps(self.init_state(), iter(batches), steps, self._generator(generator, draws), draws,
                           log_every, "consistency", graphs)

    # ---- packaging ----------------------------------------------------------------
    def student_model(self, params: Params, sample_steps: int = 1):
        """The student as a restorable model of the teacher's class whose
        sampler is the ``ConsistencySampler`` at ``sample_steps`` NFE (σ_d,
        ρ and the σ bounds carried); its ``params`` and ``ema_params`` both
        the student's."""
        cfg = copy.deepcopy(from_dict(self.model.cfg))
        sampler_cfg = dict(cfg.get("sampler", {}))
        sampler_cfg["_target_"] = "diffusion_model_nemo.modules.ConsistencySampler"
        sampler_cfg["sample_steps"] = int(sample_steps)
        sampler_cfg["sigma_data"] = self.sigma_data
        sampler_cfg["rho"] = self.rho
        if self.sigma_min is not None:
            sampler_cfg["sigma_min"] = float(self.sigma_min)
        if self.sigma_max is not None:
            sampler_cfg["sigma_max"] = float(self.sigma_max)
        sampler_cfg["objective"] = self.teacher_objective
        for k in ("eta", "ddim_timesteps", "solver_steps", "solver_order", "time_spacing"):
            sampler_cfg.pop(k, None)
        cfg["sampler"] = sampler_cfg
        return _student(self.model, cfg, params)
