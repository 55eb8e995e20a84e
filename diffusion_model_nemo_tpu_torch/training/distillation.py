"""Progressive distillation (Salimans & Ho 2022) of a DDPM-family teacher
into a few-step DDIM student.

Counterpart of ``diffusion_model_nemo_tpu/training/distillation.py``. A
phase teaches a student to match two deterministic teacher DDIM half-steps
with one of its own, halving the step count: T/2 → T/4 → … → N. The
student's N-step grid visits t ∈ {0, s, 2s, …, T − s} (s = T/N) and steps
t → t − s, ending 0 → −1 (ᾱ = 1); the teacher's grid adds the midpoints
t − s/2, so the t = 0 target is the teacher's own x̂₀. ``substeps = 1`` is
the objective transfer: the target is the teacher's x̂₀ at the same (x, t),
which re-parameterizes an ε-teacher into a v-student before the first
halving. ``guidance_scale = w`` (a class-conditional teacher) makes the
teacher the guided combination ε_u + w·(ε_c − ε_u) (``ConditionalDDPM.
_cfg_forward``, one call on 2B rows): the student absorbs it into one call
(Meng et al. 2023, stage 1), in the one stage that still regresses the
original teacher.

A step is one device program, as the JAX package's one jitted dispatch: the
teacher's calls (no autograd; each x̂₀ clipped to [−1, 1], ε̂ raw), the
closed-form x̂₀ target (float32: the gathers from the extended ᾱ table
[T + 1], indexed with [B] tensors at t + 1, and the solve of one student
DDIM step for its x̂₀), the truncated-SNR or uniform weight, the student's
forward and backward (``trainer.param_grads``), the global-norm clip and
AdamW at optax's default betas with a constant rate (``optim.py``), in
place. Both networks run deterministically: no dropout and no label
null-mask. On CUDA the step is one captured graph (``step_graph.py``): the
batch's arrays (the uint8 images, and the labels or caption tokens a
conditional teacher reads), the flip mask, the t draw, ε and the
optimizer's row are static buffers refilled every step; the guidance scale
is a float32 0-d buffer. The graph is kept in its phase's state, keyed on
(stride, teacher objective, substeps, guided, shapes) and held to the
teacher's and the student's tensors, so a phase whose teacher is the last
phase's student captures anew; it goes, pool and all, with its state when
the phase ends (a finished phase's student is never stepped again). The
draws are injected (``draws``) or drawn from a ``torch.Generator`` (the JAX
step splits its key inside the jit: the streams differ).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.yaml_config import from_dict
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import Conditioned
from ..modules.parts import not_ported
from ..ops import graphs as graphs_lib
from .optim import clip_by_global_norm
from .step_graph import OptimizerRows, adamw, replayed
from .trainer import param_grads

__all__ = ["DistillState", "ProgressiveDistiller", "predict_eps_x0"]

log = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] → [B, 1, …] for image-shaped broadcasting."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _gather(table: torch.Tensor, idx: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[idx] for a [B] index tensor, as a column (a capture forbids
    indexing with a 0-d tensor)."""
    return _col(table.index_select(0, idx.reshape(-1).long()), ndim)


def network_out(fn, params: Params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The network's output at (x, t); of a learned variance (2C channels)
    the first half."""
    out = fn(params, x, t)
    return out[..., : x.shape[-1]] if out.shape != x.shape else out


def predict_eps_x0(objective: str, out: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                   sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact (ε̂, x̂₀) of a network output under any objective;
    ``alpha`` / ``sigma`` are √ᾱ and √(1 − ᾱ) at the output's time (the
    three parameterizations are linear bijections given (x, t))."""
    if objective == "pred_noise":
        eps = out
        x0 = (x - sigma * eps) / alpha
    elif objective == "pred_v":
        x0 = alpha * x - sigma * out
        eps = sigma * x + alpha * out
    elif objective == "pred_x0":
        x0 = out
        eps = (x - alpha * x0) / sigma
    else:
        raise ValueError(f"unknown objective {objective!r}")
    return eps, x0


class FusedStep:
    """What the distillers share: AdamW at optax's default betas and a
    constant rate after the global-norm clip, the optimizer's rows, and a
    step that runs eagerly or as a replay of one captured graph kept in its
    state's ``graphs`` (``step_graph.replayed``)."""

    model: Any

    def _init_optimizer(self, learning_rate: float, weight_decay: float, grad_clip: float) -> None:
        self.optimizer = adamw(learning_rate, weight_decay)
        self.grad_clip = float(grad_clip)
        self._rows = OptimizerRows(self.optimizer, self.model.device)
        self.graph_log: List[Dict[str, Any]] = []  # each finished run's graphs: name, tag, capture s, nodes, pool MiB

    def _unused(self):
        return getattr(self.model.diffusion_model, "unused_params", frozenset())

    def _update(self, student: Params, loss: torch.Tensor, opt_state: Dict, scalars: torch.Tensor) -> None:
        grads = param_grads(loss, student, self._unused())
        with torch.no_grad():
            grads = clip_by_global_norm(grads, self.grad_clip)
            self.optimizer.step(student, grads, opt_state, scalars=scalars)

    def _run_step(self, state, key: tuple, batch, draws: Dict[str, torch.Tensor], graphs: Optional[bool],
                  step: Callable, writes: Sequence[torch.Tensor], sources: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update: ``step(batch, draws, scalars)`` eagerly, or the
        state's graph of it (default on CUDA: its first call runs eagerly
        and captures; ``key[0]`` names it) replayed with the batch's arrays
        and the draws copied in. Returns the loss (a device tensor)."""
        dev = self.model.device
        draws = {k: v.to(dev) for k, v in draws.items()}
        scalars = self._rows[state.opt_state["count"]]
        with torch.inference_mode(False):
            if graphs_lib.use_graphs(graphs, dev):
                loss = replayed(state.graphs, key[0], batch, {**draws, "opt": scalars},
                                lambda b, i: step(b, {k: i[k] for k in draws}, i["opt"]), dev, writes, sources,
                                key=key[1:]).clone()
            else:
                loss = step(batch, draws, scalars)
        state.opt_state["count"] += 1
        return loss

    def _finish(self, state, tag: str) -> Params:
        """The run's student (detached), its graphs' figures logged and kept
        in ``graph_log``; the graphs go with the state."""
        for g in state.graphs.values():
            info = dict(g.info, tag=tag)
            self.graph_log.append(info)
            log.info(f"[{tag}] graph {info['name']}: capture {info['capture_s']:.3f} s, {info['nodes']} nodes, "
                     f"pool {info['pool_mib']:.1f} MiB, {info['replays']} replays; released with the run")
        return {k: v.detach() for k, v in state.student.items()}

    def _steps(self, state, batches: Iterator, steps: int, generator, draws: Optional[Iterator], log_every: int,
               tag: str, graphs: Optional[bool]) -> Tuple[Params, List[float]]:
        """``steps`` updates of ``state``, a batch each from ``batches`` and
        its draws from ``draws`` or ``generator``; the losses logged every
        ``log_every`` steps and at the last."""
        losses: List[float] = []
        for i in range(int(steps)):
            batch = next(batches)
            d = next(draws) if draws is not None else self.draw_inputs(state, np.shape(batch["image"]), generator)
            loss = self.train_step(state, batch, d, graphs)
            if log_every and (i % log_every == 0 or i == steps - 1):
                losses.append(float(loss))
                log.info(f"[{tag}] step {i}: loss {losses[-1]:.5f}")
        return self._finish(state, tag), losses

    def _generator(self, generator: Optional[torch.Generator], draws) -> Optional[torch.Generator]:
        if generator is None and draws is None:
            return torch.Generator(device=self.model.device).manual_seed(0)
        return generator


@dataclass
class DistillState:
    """A run's teacher (read only), its student (updated in place), the
    student's optimizer state (``count``: updates done), what the step is
    (``stride`` of the student's grid, the teacher's objective, 2 teacher
    half-steps or 1, guided) and its captured graph."""

    teacher: Params
    student: Params
    opt_state: Dict
    stride: int
    teacher_objective: str
    substeps: int
    guided: bool
    graphs: Dict[tuple, Any] = field(default_factory=dict)


class ProgressiveDistiller(FusedStep):
    """Progressive distillation phases over a DDPM-family model (its
    ``params`` are the teacher).

    ``student_objective``: the student's parameterization (default
    ``pred_v``; None keeps the teacher's); ``learning_rate`` /
    ``weight_decay`` / ``grad_clip``: the student's AdamW; ``loss_weighting``:
    ``truncated_snr`` (max(SNR, 1) on the x₀ error) or ``uniform``;
    ``guidance_scale``: the guided teacher (a class-conditional model and
    labeled batches). ``mesh=`` is not ported."""

    def __init__(self, model, student_objective: Optional[str] = "pred_v", learning_rate: float = 1e-4,
                 weight_decay: float = 0.0, grad_clip: float = 1.0, loss_weighting: str = "truncated_snr",
                 guidance_scale: Optional[float] = None, mesh=None):
        if mesh is not None:
            raise not_ported("ProgressiveDistiller", "mesh=", "parallelism")
        if loss_weighting not in ("truncated_snr", "uniform"):
            raise ValueError(f"unknown loss_weighting {loss_weighting!r}")
        # The guided step calls ConditionalDDPM._cfg_forward(params, x, t,
        # classes, w): a text-conditional model's has another signature.
        if guidance_scale is not None and not (
            hasattr(model, "_cfg_forward") and getattr(model, "num_classes", None) is not None
        ):
            raise ValueError(
                "guidance_scale requires a class-conditional model"
                " (ConditionalDDPM) as the teacher; text-conditional teachers"
                " are not supported for guided distillation"
            )
        self.guidance_scale = None if guidance_scale is None else float(guidance_scale)
        self.model = model
        self.timesteps = int(model.timesteps)
        self.teacher_objective = str(model.sampler.objective)
        self.student_objective = str(student_objective or self.teacher_objective)
        if self.student_objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"bad student objective {self.student_objective!r}")
        self.loss_weighting = loss_weighting
        dev = model.device
        acp = model.sampler.constants.alphas_cumprod.to(device=dev, dtype=torch.float32)
        self._acp_ext = torch.cat([torch.ones(1, dtype=torch.float32, device=dev), acp])
        self._scale = (None if self.guidance_scale is None
                       else torch.tensor(self.guidance_scale, dtype=torch.float32, device=dev))
        self._init_optimizer(learning_rate, weight_decay, grad_clip)

    # ---- the fused step -------------------------------------------------------
    def init_state(self, teacher: Params, teacher_objective: Optional[str] = None, stride: int = 1,
                   substeps: int = 1, guided: bool = False) -> DistillState:
        """A run: the student a copy of ``teacher``, a fresh optimizer
        state. ``substeps=2`` is a halving phase (teacher half-steps of
        ``stride // 2``), ``1`` the objective transfer; ``guided`` wraps the
        teacher in the guided combination (only the original teacher:
        a student has absorbed w, and wrapping it again compounds it)."""
        if guided and self.guidance_scale is None:
            raise ValueError("guided step requested but no guidance_scale was set")
        student = {k: v.detach().clone().requires_grad_(True) for k, v in teacher.items()}
        return DistillState(teacher, student, self.optimizer.init(student), int(stride),
                            str(teacher_objective or self.teacher_objective), int(substeps), bool(guided))

    def draw_inputs(self, state: DistillState, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """A step's draws for a batch of ``shape`` [B, H, W, C]: the flip
        mask (p = 0.5), t (a phase: a multiple of the stride below T; the
        transfer: any t < T; int32) and ε."""
        B, dev = int(shape[0]), self.model.device
        flip = torch.rand((B,), generator=generator, device=dev) < 0.5
        if state.substeps == 2:
            t = torch.randint(0, self.timesteps // state.stride, (B,), generator=generator, device=dev) * state.stride
        else:
            t = torch.randint(0, self.timesteps, (B,), generator=generator, device=dev)
        eps = torch.randn(tuple(shape), generator=generator, device=dev, dtype=torch.float32)
        return {"flip": flip, "t": t.to(torch.int32), "eps": eps}

    def _teacher_eps_x0(self, fn, params: Params, x: torch.Tensor, t: torch.Tensor, objective: str):
        """The teacher's (ε̂, x̂₀ clipped to [−1, 1]) at (x, t), as DDIM's step takes them."""
        a = _gather(self._acp_ext, t + 1, x.ndim)
        eps, x0 = predict_eps_x0(objective, network_out(fn, params, x, t), x, torch.sqrt(a), torch.sqrt(1.0 - a))
        return eps, x0.clamp(-1.0, 1.0)

    def target(self, state: DistillState, fn, x: torch.Tensor, t: torch.Tensor, labels=None) -> torch.Tensor:
        """The x̂₀ the student regresses at (x, t) (no autograd): the
        teacher's x̂₀ (transfer, and every phase at t = 0), or the x̂₀ that
        makes one student DDIM step t → t − s land where the teacher's two
        half-steps do."""
        if state.guided:
            fn = Conditioned(self.model._cfg_forward, {"classes": labels, "guidance_scale": self._scale})
        ndim, obj = x.ndim, state.teacher_objective
        eps1, x01 = self._teacher_eps_x0(fn, state.teacher, x, t, obj)
        if state.substeps != 2:
            return x01
        m = torch.clamp(t - state.stride // 2, min=0)
        n = torch.clamp(t - state.stride, min=-1)
        a_t, a_m, a_n = (_gather(self._acp_ext, i + 1, ndim) for i in (t, m, n))
        al_t, sg_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        al_m, sg_m = torch.sqrt(a_m), torch.sqrt(1.0 - a_m)
        al_n, sg_n = torch.sqrt(a_n), torch.sqrt(1.0 - a_n)
        eps2, x02 = self._teacher_eps_x0(fn, state.teacher, al_m * x01 + sg_m * eps1, m, obj)
        z = al_n * x02 + sg_n * eps2
        ratio = sg_n / sg_t
        x0_tgt = (z - ratio * x) / (al_n - ratio * al_t)
        return torch.where(_col(t == 0, ndim), x01, x0_tgt)  # the shared 0 → −1 step

    def loss(self, state: DistillState, batch, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The weighted x̂₀ regression of the student onto the target, on a
        raw uint8 batch (flipped by ``draws["flip"]``) at ``draws["t"]``
        with ``draws["eps"]``; autograd to the student."""
        model = self.model
        proc = preprocess_batch(batch, model.device, flip=draws["flip"])
        x0_data, t, eps = proc["pixel_values"], draws["t"], draws["eps"]
        ndim = x0_data.ndim
        fn = model.get_model_fn(proc, training=True)  # no dropout masks, no label mask: deterministic
        with torch.no_grad():
            a_t = _gather(self._acp_ext, t + 1, ndim)
            al_t, sg_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
            x = al_t * x0_data + sg_t * eps
            x0_tgt = self.target(state, fn, x, t, proc.get("label"))
        _, x0_s = predict_eps_x0(self.student_objective, network_out(fn, state.student, x, t), x, al_t, sg_t)
        err = (x0_s - x0_tgt) ** 2
        if self.loss_weighting == "truncated_snr":
            err = torch.clamp_min(a_t / (1.0 - a_t), 1.0) * err
        return torch.mean(err)

    def _step(self, state: DistillState, batch, draws, scalars: torch.Tensor) -> torch.Tensor:
        """The step itself, device work only (the captured function)."""
        loss = self.loss(state, batch, draws)
        self._update(state.student, loss, state.opt_state, scalars)
        return loss.detach()

    def train_step(self, state: DistillState, batch, draws: Dict[str, torch.Tensor],
                   graphs: Optional[bool] = None) -> torch.Tensor:
        """One update of ``state`` on a raw batch with the step's draws
        (``draw_inputs``'). ``graphs``: replay the captured step (default:
        on CUDA) or run it eagerly; the same numbers. Returns the loss."""
        writes = [*state.student.values(), *(v for d in ("mu", "nu") for v in state.opt_state[d].values())]
        sources = [*state.teacher.values(), self._acp_ext, *([self._scale] if state.guided else [])]
        key = ("distill_step", state.stride, state.teacher_objective, state.substeps, state.guided)
        return self._run_step(state, key, batch, draws, graphs,
                              lambda b, d, s: self._step(state, b, d, s), writes, sources)

    # ---- the phases ---------------------------------------------------------------
    def transfer_objective(self, batches: Iterator, steps: int, generator: Optional[torch.Generator] = None,
                           log_every: int = 50, guided: Optional[bool] = None, draws: Optional[Iterable] = None,
                           graphs: Optional[bool] = None) -> Tuple[Params, List[float]]:
        """Re-parameterize the teacher into ``student_objective`` (direct
        output-space regression, no step-count change); with a
        ``guidance_scale`` it also absorbs the guidance (it regresses the
        original teacher). Returns (the student's parameters, the losses)."""
        guided = (self.guidance_scale is not None) if guided is None else bool(guided)
        state = self.init_state(self.model.params, self.teacher_objective, 1, 1, guided)
        draws = iter(draws) if draws is not None else None
        return self._steps(state, iter(batches), steps, self._generator(generator, draws), draws, log_every,
                           "distill transfer", graphs)

    def distill_phase(self, teacher_params: Params, teacher_objective: str, student_steps: int, batches: Iterator,
                      steps: int, generator: Optional[torch.Generator] = None, log_every: int = 50,
                      guided: bool = False, draws: Optional[Iterable] = None,
                      graphs: Optional[bool] = None) -> Tuple[Params, List[float]]:
        """One halving phase: the teacher at 2·``student_steps`` → a student
        at ``student_steps`` (T % student_steps == 0 and an even stride, so
        that the teacher's midpoint is on the grid). ``guided`` only when
        ``teacher_params`` is the original guided teacher."""
        T = self.timesteps
        if student_steps <= 0 or T % student_steps != 0:
            raise ValueError(f"student_steps must divide timesteps={T}, got {student_steps}")
        stride = T // student_steps
        if stride % 2 != 0:
            raise ValueError(
                f"stride {stride} (= {T}/{student_steps}) must be even so the"
                " teacher midpoint lies on the discrete grid"
            )
        state = self.init_state(teacher_params, teacher_objective, stride, 2, guided)
        draws = iter(draws) if draws is not None else None
        return self._steps(state, iter(batches), steps, self._generator(generator, draws), draws, log_every,
                           f"distill N={student_steps}", graphs)

    def halving_schedule(self, final_steps: int) -> List[int]:
        """The phases' student step counts T/2, T/4, … down to
        ``final_steps``; raises when halving does not reach it."""
        T = self.timesteps
        schedule = []
        n = T // 2
        while n >= final_steps and (T % n == 0) and ((T // n) % 2 == 0):
            schedule.append(n)
            if n == final_steps:
                break
            n //= 2
        if not schedule or schedule[-1] != final_steps:
            raise ValueError(
                f"final_steps={final_steps} is not reachable by halving from"
                f" timesteps={T} (reachable: {schedule})"
            )
        return schedule

    def distill(self, batches: Iterator, final_steps: int, steps_per_phase: int,
                generator: Optional[torch.Generator] = None, transfer_steps: int = 0, log_every: int = 50,
                draws: Optional[Iterable] = None, graphs: Optional[bool] = None) -> Tuple[Params, Dict[str, List[float]]]:
        """The recipe: the objective transfer when the objectives differ
        (``transfer_steps`` > 0 then), then the halving phases down to
        ``final_steps``; the draws from ``generator`` (default seeded 0) or
        the next of ``draws`` (one a step, in the run's order). Returns
        (the last student's parameters, the losses by phase)."""
        schedule = self.halving_schedule(final_steps)
        batches = iter(batches)
        draws = iter(draws) if draws is not None else None
        generator = self._generator(generator, draws)
        teacher_params, teacher_objective = self.model.params, self.teacher_objective
        # Guidance is absorbed exactly once, by the stage that still
        # regresses the original teacher: a later stage's teacher already
        # emits guided outputs, and wrapping it again compounds the scale.
        guided_next = self.guidance_scale is not None
        history: Dict[str, List[float]] = {}
        if self.student_objective != self.teacher_objective:
            if transfer_steps <= 0:
                raise ValueError(
                    "student_objective differs from the teacher's — pass"
                    " transfer_steps > 0 to re-parameterize first"
                )
            teacher_params, history["transfer"] = self.transfer_objective(
                batches, transfer_steps, generator, log_every, guided=guided_next, draws=draws, graphs=graphs)
            teacher_objective, guided_next = self.student_objective, False
        for n in schedule:
            teacher_params, history[f"N={n}"] = self.distill_phase(
                teacher_params, teacher_objective, n, batches, steps_per_phase, generator, log_every,
                guided=guided_next, draws=draws, graphs=graphs)
            teacher_objective, guided_next = self.student_objective, False
        return teacher_params, history

    # ---- packaging ----------------------------------------------------------------
    def student_model(self, params: Params, student_steps: int):
        """The distilled parameters as a restorable model of the teacher's
        class whose sampler is the ``student_steps``-step DDIM (η = 0) in
        the student's objective; its ``params`` and ``ema_params`` both the
        student's."""
        model = self.model
        cfg = copy.deepcopy(from_dict(model.cfg))
        sampler_cfg = dict(cfg.get("sampler", {}))
        sampler_cfg["_target_"] = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
        sampler_cfg["objective"] = self.student_objective
        sampler_cfg["eta"] = 0.0
        sampler_cfg["ddim_timesteps"] = int(student_steps)
        sampler_cfg.pop("solver_steps", None)
        cfg["sampler"] = sampler_cfg
        return _student(model, cfg, params)


def _student(model, cfg, params: Params):
    """A model of ``model``'s class built from ``cfg`` with ``params`` as
    its weights and EMA."""
    student = type(model)(cfg, device=model.device, seed=model.seed)
    student.params = {k: v.detach().clone() for k, v in params.items()}
    student.ema_params = {k: v.clone() for k, v in student.params.items()}
    return student
