"""Reflow / rectification of a flow-matching model (Liu et al. 2022 §3).

Counterpart of ``diffusion_model_nemo_tpu/training/reflow.py``. A round
retrains a student on the teacher's own transport: z ~ N(0, I), x = the
teacher's ODE from z (``p_sample_loop(img=z, num_steps=pair_steps,
unnormalize=False)``), then the flow-matching regression on the pair,

    x_t = (1 − t)·x + t·z,   target  v = z − x,

with the mean squared error (not the model's configured loss), the
global-norm clip and AdamW at optax's default betas (0.9, 0.999) and a
constant learning rate (``optim.py``'s ``Optimizer`` and
``clip_by_global_norm``, which follow optax step for step). Round k's
teacher is round k − 1's student; each round starts the student from a
copy of its teacher with a fresh optimizer state.

One step is one device program, as the JAX package's one jitted dispatch:
the teacher's whole chain (no autograd), the path point, the student's
forward and backward (no dropout), the clip and the update in place. On
CUDA it is one captured graph (``ops/graphs.py``): z, the time draw and the
optimizer's row are static buffers refilled every step, and the graph is
held to the teacher's and the student's tensors, so a new round (new
tensors) captures anew and never replays the last round's teacher. The
draws are injected (``train_step``'s ``z`` and ``time``; ``reflow``'s
``draws``) or drawn from a ``torch.Generator`` (the JAX package draws z
from numpy and t from ``fold_in(key, 1)``: the streams differ).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..config.yaml_config import from_dict
from ..modules.gaussian_diffusion import _randn
from ..modules.parts import not_ported
from ..ops import graphs as graphs_lib
from .optim import clip_by_global_norm
from .step_graph import OptimizerRows, adamw, replayed
from .trainer import param_grads

__all__ = ["ReflowState", "ReflowTrainer"]

log = logging.getLogger(__name__)


@dataclass
class ReflowState:
    """A round's teacher (read only), its student (updated in place) and
    the student's optimizer state (``count``: updates done)."""

    teacher: Dict[str, torch.Tensor]
    student: Dict[str, torch.Tensor]
    opt_state: Dict


class ReflowTrainer:
    """Rectify a trained ``RectifiedFlow`` (its ``params`` are the first
    teacher). ``pair_steps``: the grid of the teacher's chain (default the
    sampler's ``sample_steps``); ``mesh=`` is not ported."""

    def __init__(self, model, pair_steps: Optional[int] = None, learning_rate: float = 1e-4,
                 weight_decay: float = 0.0, grad_clip: float = 1.0, mesh=None):
        if mesh is not None:
            raise not_ported("ReflowTrainer", "mesh=", "parallelism")
        self.model = model
        self.sampler = model.sampler
        self.pair_steps = int(pair_steps) if pair_steps else int(self.sampler.sample_steps)
        self.grad_clip = float(grad_clip)
        self.optimizer = adamw(learning_rate, weight_decay)
        self.graphs: dict = {}  # the captured step (ops/graphs.py)
        self._rows = OptimizerRows(self.optimizer, model.device)

    # ---- the fused step -------------------------------------------------------
    def init_state(self, teacher: Dict[str, torch.Tensor]) -> ReflowState:
        """A round: the student a copy of ``teacher``, a fresh optimizer state."""
        student = {k: v.detach().clone().requires_grad_(True) for k, v in teacher.items()}
        return ReflowState(teacher, student, self.optimizer.init(student))

    def _step(self, state: ReflowState, z: torch.Tensor, time: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
        """The step itself, device work only (the captured function): the
        teacher's chain, the pair's path point, the student's loss and
        gradients, the clip and the AdamW update. Returns the loss."""
        model, sampler = self.model, self.sampler
        with torch.no_grad():
            x = sampler.p_sample_loop(model.train_model_fn, state.teacher, tuple(z.shape), img=z,
                                      num_steps=self.pair_steps, unnormalize=False, graphs=False)
            t = sampler.sample_times(time)
            x_t = sampler.q_sample(x, t, z)  # the pair's path reuses z as its noise endpoint
            target = sampler.v_target(x, z)
        out = model.train_model_fn(state.student, x_t, sampler.model_time(t))
        loss = torch.mean((out - target) ** 2)
        grads = param_grads(loss, state.student, getattr(model.diffusion_model, "unused_params", frozenset()))
        with torch.no_grad():
            grads = clip_by_global_norm(grads, self.grad_clip)
            self.optimizer.step(state.student, grads, state.opt_state, scalars=scalars)
        return loss.detach()

    def train_step(self, state: ReflowState, z: torch.Tensor, time: torch.Tensor,
                   graphs: Optional[bool] = None) -> torch.Tensor:
        """One update of ``state`` with the latents ``z`` [B, H, W, C] and the
        time draw [B] (``sampler.draw_times``'s). ``graphs``: replay the
        captured step (default: on CUDA; its first call runs eagerly and
        captures) or run it eagerly; the same numbers. Returns the loss."""
        dev = self.model.device
        z, time = z.to(dev, torch.float32), time.to(dev, torch.float32)
        scalars = self._rows[state.opt_state["count"]]
        with torch.inference_mode(False):
            if graphs_lib.use_graphs(graphs, dev):
                loss = self._replayed(state, z, time, scalars)
            else:
                loss = self._step(state, z, time, scalars)
        state.opt_state["count"] += 1
        return loss

    def _replayed(self, state: ReflowState, z, time, scalars) -> torch.Tensor:
        writes = [*state.student.values(), *(v for d in ("mu", "nu") for v in state.opt_state[d].values())]
        table = self.sampler._table(self.pair_steps, False)  # the teacher chain's grid, made before a capture
        out = replayed(self.graphs, "reflow_step", {}, {"z": z, "time": time, "opt": scalars},
                       lambda _b, i: self._step(state, i["z"], i["time"], i["opt"]), self.model.device, writes,
                       [*state.teacher.values(), table], key=(self.pair_steps,))
        return out.clone()

    # ---- the rounds -------------------------------------------------------------
    def reflow(self, steps: int, batch_size: int, generator: Optional[torch.Generator] = None, rounds: int = 1,
               log_every: int = 50, draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
               graphs: Optional[bool] = None) -> Tuple[Dict[str, torch.Tensor], List[float]]:
        """``rounds`` rounds of ``steps`` updates at ``batch_size``; each
        step's (z, time draw) from ``generator`` (default seeded 0), or the
        next pair of ``draws`` (one a step, rounds × steps). Returns (the
        last student's parameters, the losses logged every ``log_every``
        steps and at each round's last)."""
        model = self.model
        shape = (int(batch_size), int(model.image_size), int(model.image_size), int(model.channels))
        pairs = iter(draws) if draws is not None else None
        if pairs is None and generator is None:
            generator = torch.Generator(device=model.device).manual_seed(0)
        teacher, losses = model.params, []
        for r in range(int(rounds)):
            state = self.init_state(teacher)
            for i in range(int(steps)):
                if pairs is not None:
                    z, u = next(pairs)
                else:
                    z, u = _randn(shape, generator, model.device), self.sampler.draw_times(shape[0], generator)
                loss = self.train_step(state, z, u, graphs)
                if log_every and (i % log_every == 0 or i == steps - 1):
                    losses.append(float(loss))
                    log.info(f"[reflow round {r + 1}] step {i}: loss {losses[-1]:.5f}")
            teacher = {k: v.detach() for k, v in state.student.items()}
        return teacher, losses

    # ---- packaging ----------------------------------------------------------------
    def student_model(self, params: Dict[str, torch.Tensor], sample_steps: int = 1):
        """The rectified parameters as a restorable ``RectifiedFlow`` whose
        sampler defaults to ``sample_steps`` (1 after a round: the paper's
        headline configuration); its ``params`` and ``ema_params`` both the
        student's."""
        from ..models import RectifiedFlow

        cfg = copy.deepcopy(from_dict(self.model.cfg))
        cfg["sampler"]["sample_steps"] = int(sample_steps)
        student = RectifiedFlow(cfg, device=self.model.device, seed=self.model.seed)
        student.params = {k: v.detach().clone() for k, v in params.items()}
        student.ema_params = {k: v.clone() for k, v in student.params.items()}
        return student
