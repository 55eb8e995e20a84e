"""Training loop on one device, and the dataset test loop.

Counterpart of ``diffusion_model_nemo_tpu/training/trainer.py`` (``fit``,
``test``, ``_build_update_fn``, ``_accumulated``, ``_apply_precision``,
``_resolve_limit_batches``). Config fields mirror the reference YAML
``trainer`` block. One optimizer step: the model's ``training_step`` (loss
of the network on the step's batch and draws), autograd, the global norm of
the raw gradients (the ``grad_norm`` metric), global-norm clip + AdamW with
its schedule (``optim.py``), then the EMA with its warm-up at the count of
steps done before the update. Parameters, optimizer state and EMA live on
the model's device and are updated in place; the host syncs only at the
logging and checkpoint cadences. On CUDA the step is one CUDA graph
(``ops/graphs.py``): the first step of a train state runs eagerly and is
then captured whole (forward, backward through the plain recomputes,
global norm, clip, AdamW, EMA, post-hoc EMA), and every later step copies
its batch, its draws and its rows of the optimizer's and the EMA's scalar
tables (``optim.py``, ``ema.py``; grown on the host as the steps go on) into
the graph's static buffers and replays it. ``steps_per_execution = K`` runs
K steps between host syncs, as the JAX trainer's multi-step dispatch does:
logging, the sample dump and the NaN check quantize to K-step boundaries
(JAX's ``_crossed`` rule), checkpoints keep ``step % checkpoint_every_n_steps``,
an epoch's batches go in groups of K (a trailing incomplete group is
dropped) and a tail shorter than K runs single steps.

``accumulate_grad_batches = K`` stacks K micro-batches of the loader (and
their K draws) into one step, [K, B, ...], an epoch's trailing incomplete
group dropped: the gradients of the micro-batches are summed and divided by
K and the metrics averaged, and ``step``, the schedule, the EMA and every
cadence count optimizer steps; on CUDA the whole step is one captured graph.
``steps_per_execution > 1`` beside it warns and runs single-step dispatch.

Services, as in the JAX trainer: the ``save_every`` sample dump (and
bits/dim of the step's batch under ``compute_bpd``), the ``exp_manager``
hooks (metrics, image logging, checkpoints every
``checkpoint_every_n_steps``, the final archive), and resume from a
checkpoint's state: params, EMA, optimizer state, post-hoc EMA, step, the
draw generator's state and the data position, so that a resumed run is
bit-identical to an uninterrupted one. The draws come from one
``torch.Generator`` seeded with ``seed`` (the JAX package derives a key per
step instead; the two streams differ, the resume contract is the same).
``posthoc_ema_sigma_rels`` tracks the power-function averages of
``posthoc_ema.py`` after every optimizer step (in the step's graph), writes
them every ``posthoc_ema_every_n_steps`` steps and at the end, and carries
them through checkpoints (``steps_per_execution > 1`` warns and disables it,
as in JAX). ``profile_dir`` traces steps ``profile_start_step`` … ``+
profile_num_steps`` with torch.profiler (``tools/profiling.py:WindowTrace``:
a trace that kept none of the steps' events raises instead of being
written). The loader's batches (grouped, and pinned on CUDA) are built ahead
by a ``ThreadedPrefetcher`` thread in ``fit`` and ``test``.

Options of the JAX trainer that would change the run and are not ported
raise at ``fit`` start: any strategy but one device, PTL's
``resume_from_checkpoint`` and ``enable_checkpointing`` (exp_manager resumes
and checkpoints).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.hf_vision_data import preprocess_batch
from ..data.prefetch import ThreadedPrefetcher
from ..modules.parts import not_ported
from ..ops import graphs as graphs_lib
from ..tools.profiling import WindowTrace
from .ema import ema_decay_table, ema_update, init_ema
from .optim import Optimizer, build_optimizer, global_norm
from .posthoc_ema import PostHocEMA
from .step_graph import replayed

__all__ = ["Trainer", "TrainState", "param_grads"]

log = logging.getLogger(__name__)

_ONE_DEVICE_STRATEGIES = (None, "ddp", "none", "null", "auto", "dp", "single_device")


def param_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor], unused=frozenset()) -> Dict[str, torch.Tensor]:
    """d loss / d params by name. A parameter named in ``unused`` (one its
    network declares the loss never reads, as the WaveGrad U-Net's deepest
    FiLM, whose statistics the JAX network discards) gets a zero gradient;
    any other parameter the loss does not read is an error, as autograd's."""
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=bool(unused))
    missing = [k for k, g in zip(keys, grads) if g is None and k not in unused]
    if missing:
        raise RuntimeError(f"the loss does not read {missing}, which the network does not declare unused")
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, grads)}


@dataclass
class TrainState:
    """Parameters, EMA and optimizer state; ``step`` counts completed steps.
    ``graphs`` holds the state's captured training step (``ops/graphs.py``):
    it goes with the state. ``phema``: the post-hoc EMA's averages, one
    parameter dict a tracked σ_rel (None without post-hoc EMA)."""

    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int = 0
    graphs: Dict[tuple, Any] = field(default_factory=dict)
    phema: Optional[List[Dict[str, torch.Tensor]]] = None


class _Groups:
    """The loader's batches ``k`` at a time, an epoch's trailing incomplete
    group dropped: lists of batches, or (``stack``) one dict of arrays
    stacked [k, B, ...], as the JAX trainer's ``_accumulated`` stacks them.
    Iterable again for every epoch."""

    def __init__(self, loader, k: int, stack: bool):
        self.loader, self.k, self.stack = loader, int(k), bool(stack)

    def __len__(self) -> int:
        return len(self.loader) // self.k

    def __iter__(self):
        for group in Trainer._grouped(self.loader, self.k):
            yield {key: np.stack([b[key] for b in group]) for key in group[0]} if self.stack else group


class Trainer:
    def __init__(
        self,
        devices: int = -1,
        num_nodes: int = 1,
        max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: Optional[float] = 1.0,
        precision: Any = 32,
        log_every_n_steps: int = 10,
        ema_decay: float = 0.9999,
        seed: int = 42,
        strategy: Optional[str] = None,
        steps_per_execution: int = 1,
        profile_dir: Optional[str] = None,
        profile_start_step: int = 10,
        profile_num_steps: int = 5,
        terminate_on_nan: bool = True,
        posthoc_ema_sigma_rels: Optional[Any] = None,
        posthoc_ema_every_n_steps: int = 1024,
        posthoc_ema_dir: Optional[str] = None,
        limit_test_batches: Optional[float] = None,
        resume_from_checkpoint: Optional[str] = None,
        enable_checkpointing: bool = False,
        **_unused,
    ):
        self.devices, self.num_nodes = devices, num_nodes
        self.max_epochs, self.max_steps = max_epochs, max_steps
        self.accumulate_grad_batches = max(int(accumulate_grad_batches or 1), 1)
        self.steps_per_execution = max(int(steps_per_execution or 1), 1)
        if self.steps_per_execution > 1 and self.accumulate_grad_batches > 1:
            log.warning("steps_per_execution > 1 is unsupported with accumulate_grad_batches > 1; "
                        "running single-step dispatch")
            self.steps_per_execution = 1
        # Post-hoc EMA needs one optimizer step a dispatch (its update runs
        # at every step's profile time t), as in the JAX trainer.
        self.posthoc_ema_sigma_rels = (
            [float(v) for v in posthoc_ema_sigma_rels] if posthoc_ema_sigma_rels else None
        )
        self.posthoc_ema_every_n_steps = int(posthoc_ema_every_n_steps)
        self.posthoc_ema_dir = posthoc_ema_dir
        if self.posthoc_ema_sigma_rels and self.steps_per_execution > 1:
            log.warning("posthoc_ema is unsupported with steps_per_execution > 1; disabling it")
            self.posthoc_ema_sigma_rels = None
        self.phema: Optional[PostHocEMA] = None
        self.gradient_clip_val = gradient_clip_val
        self.precision = precision
        self.log_every_n_steps = int(log_every_n_steps)
        self.ema_decay = float(ema_decay)
        self.seed = int(seed)
        self.strategy = strategy
        self.profile_dir = profile_dir
        self.profile_start_step = int(profile_start_step)
        self.profile_num_steps = int(profile_num_steps)
        self.terminate_on_nan = bool(terminate_on_nan)
        self.limit_test_batches = limit_test_batches
        self.resume_from_checkpoint = resume_from_checkpoint
        self.enable_checkpointing = bool(enable_checkpointing)
        self.global_step = 0
        self.exp_manager_hooks = None  # set by exp_manager()
        self.optimizer: Optional[Optimizer] = None
        self.lr_schedule = None
        self._tables: Optional[Tuple[torch.Tensor, ...]] = None  # the optimizer's, the EMA's, the steps
        self.logged: List[Dict[str, float]] = []  # the metrics of each logging step

    # ------------------------------------------------------------------ fit ----
    def _check_ported(self, model) -> None:
        def refuse(option: str, slice_: str = "training services"):
            raise not_ported("Trainer", option, slice_)

        strategy = None if self.strategy is None else str(self.strategy).lower()
        n = int(self.devices)
        if n in (-1, 0):
            n = torch.cuda.device_count() if model.device.type == "cuda" else 1
        if strategy not in _ONE_DEVICE_STRATEGIES or n > 1 or int(self.num_nodes) > 1:
            refuse(f"strategy={self.strategy!r} on {n} device(s) x {self.num_nodes} node(s)", "parallelism")
        if self.resume_from_checkpoint:
            refuse("resume_from_checkpoint (resume through exp_manager.resume_if_exists)")
        if self.enable_checkpointing:
            refuse("enable_checkpointing=True (checkpoints come from exp_manager.checkpoint_every_n_steps)")

    def init_state(self, model, max_steps: int) -> TrainState:
        """Precision, the optimizer and its schedule (the per-step scalars
        of both and of the EMA tabled over steps 0 … ``max_steps``), and fresh
        copies of the model's parameters (leaves that require grad) and EMA."""
        self._apply_precision(model)
        self.optimizer, self.lr_schedule = build_optimizer(
            model.cfg.get("optim"), max_steps, grad_clip=self.gradient_clip_val
        )
        self._tables = self._build_tables(max_steps, model.device)
        params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
        return TrainState(params, init_ema(model.ema_params), self.optimizer.init(params))

    def _build_tables(self, n: int, device) -> Tuple[torch.Tensor, ...]:
        steps = torch.arange(n + 2, dtype=torch.float32, device=device)  # the post-hoc EMA's profile times
        return self.optimizer.table(n, device), ema_decay_table(self.ema_decay, n, device), steps

    def _scalars(self, state: TrainState, device) -> Tuple[torch.Tensor, ...]:
        """The rows of the optimizer's and the EMA's tables for the next
        step, and its profile time for the post-hoc EMA (the steps completed
        after it, float32). A table has no end: when a step passes its last
        row, all are built anew over twice its count, on the host between
        steps (a graph copies its rows into static buffers and never reads a
        table)."""
        count, step = state.opt_state["count"], state.step
        if max(count, step) >= self._tables[0].shape[0]:
            self._tables = self._build_tables(2 * max(count, step), device)
        return self._tables[0][count], self._tables[1][step], self._tables[2][step + 1]

    def train_step(self, model, state: TrainState, batch, draws,
                   graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``state``, in place; returns the step's
        metrics as device tensors (``train_loss``, ``grad_norm``). Under
        ``accumulate_grad_batches = K`` the batch's arrays and the draws are
        stacked [K, ...] (``stack_draws``). ``graphs``: replay the state's
        captured step (default: on CUDA; the first step of a state runs
        eagerly and is captured) or run it eagerly. Either way the same
        ``_step``."""
        scalars = self._scalars(state, model.device)
        if graphs_lib.use_graphs(graphs, model.device):
            metrics = self._replayed_step(model, state, batch, draws, scalars)
        else:
            metrics = self._step(model, state, batch, draws, scalars)
        state.step += 1
        state.opt_state["count"] += 1
        return metrics

    @staticmethod
    def stack_draws(draws: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """K micro-batches' draws as one dict of [K, ...] tensors."""
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    def grads(self, model, params, batch, draws) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(gradients, metrics) of the step's loss. Under
        ``accumulate_grad_batches = K`` (``batch`` and ``draws`` stacked
        [K, ...]) each micro-batch's gradients in turn, summed and divided by
        K, and the metrics averaged, as the JAX trainer's scan does."""
        unused = getattr(model.diffusion_model, "unused_params", frozenset())
        k = self.accumulate_grad_batches
        if k == 1:
            loss, metrics = model.training_step(params, batch, draws)
            return param_grads(loss, params, unused), {n: v.detach() for n, v in metrics.items()}
        total, per = None, []
        for i in range(k):
            loss, metrics = model.training_step(params, {n: v[i] for n, v in batch.items()},
                                                {n: v[i] for n, v in draws.items()})
            g = param_grads(loss, params, unused)
            total = g if total is None else {n: total[n] + g[n] for n in g}
            per.append({n: v.detach() for n, v in metrics.items()})
        return {n: g / k for n, g in total.items()}, {n: torch.stack([m[n] for m in per]).mean(0) for n in per[0]}

    def _step(self, model, state: TrainState, batch, draws, scalars) -> Dict[str, torch.Tensor]:
        """The step itself, device work only (the captured function):
        loss, gradients, global norm, clip + update, EMA, post-hoc EMA.
        ``scalars``: the optimizer's and the EMA's rows and the profile time
        (``_scalars``)."""
        grads, metrics = self.grads(model, state.params, batch, draws)
        with torch.no_grad():
            norm = global_norm(grads)
            self.optimizer.step(state.params, grads, state.opt_state, grad_norm=norm, scalars=scalars[0])
            ema_update(state.ema_params, state.params, scalars[1])
            if state.phema is not None:
                self.phema.update(state.phema, state.params, scalars[2])
        return metrics | {"grad_norm": norm}

    def _replayed_step(self, model, state: TrainState, batch, draws, scalars) -> Dict[str, torch.Tensor]:
        """``_step`` as a replay of the state's graph (``step_graph.replayed``:
        the batch's arrays, the draws and the step's scalars go into its
        static buffers first). Captured with the derived-weights cache off:
        the prenorm folds, casts and re-layouts of the changing weights are
        recomputed at every replay."""
        inputs = {**draws, "opt": scalars[0], "ema": scalars[1]}
        if state.phema is not None:
            inputs["phema_t"] = scalars[2]

        def step(b, i):
            return self._step(model, state, b, {k: i[k] for k in draws}, (i["opt"], i["ema"], i.get("phema_t")))

        writes = [*state.params.values(), *state.ema_params.values(),
                  *(v for tree in state.phema or () for v in tree.values())]
        moments = [v for d in state.opt_state.values() if isinstance(d, dict) for v in d.values()]
        tables = getattr(model.sampler, "table_tensors", tuple)()  # q_sample's, the noise level's
        frozen = getattr(model, "frozen_tensors", tuple)()  # a latent model's first stage
        out = replayed(state.graphs, "train_step", batch, inputs, step, model.device, writes,
                       [*moments, *tables, *frozen])
        return {k: v.clone() for k, v in out.items()}

    @staticmethod
    def checkpoint_state(state: TrainState, generator: torch.Generator, steps_per_epoch: int,
                         group: int = 1, steps_per_group: Optional[int] = None) -> Dict[str, Any]:
        """What a resume needs (tensors still on the device: the checkpoint
        manager copies them to the CPU). The data position is where the
        loader (``steps_per_epoch`` batches an epoch) stands after
        ``state.step`` steps taken in groups of ``group`` batches and
        ``steps_per_group`` steps (default ``group``; 1 under gradient
        accumulation), an epoch's trailing incomplete group dropped (the JAX
        trainer's fast-forward rule)."""
        spg = group if steps_per_group is None else int(steps_per_group)
        groups, per_epoch = state.step // spg, max(steps_per_epoch // group, 1)
        out = {
            "params": {k: v.detach() for k, v in state.params.items()},
            "ema_params": state.ema_params,
            "opt_state": state.opt_state,
            "step": state.step,
            "generator": generator.get_state(),
            "data_position": [groups // per_epoch, (groups % per_epoch) * group],
        }
        if state.phema is not None:
            out["phema"] = state.phema
        return out

    @staticmethod
    def _load_resume_state(state: TrainState, generator: torch.Generator, saved: Dict[str, Any]) -> None:
        def copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
            if set(dst) != set(src):
                raise KeyError(f"checkpoint keys differ: {sorted(set(dst) ^ set(src))}")
            for k, v in dst.items():
                if isinstance(v, dict):
                    copy_into(v, src[k])
                elif torch.is_tensor(v):
                    v.copy_(src[k])
                else:
                    dst[k] = src[k]

        with torch.no_grad():
            copy_into(state.params, saved["params"])
            copy_into(state.ema_params, saved["ema_params"])
            copy_into(state.opt_state, saved["opt_state"])
            if state.phema is not None and saved.get("phema") is not None:
                for tree, src in zip(state.phema, saved["phema"]):
                    copy_into(tree, src)
        state.step = int(saved["step"])
        generator.set_state(saved["generator"])

    def fit(self, model, resume_state: Optional[Dict[str, Any]] = None, graphs: Optional[bool] = None) -> None:
        """Train ``model`` for ``max_steps`` (or ``max_epochs``), from
        ``resume_state`` if given. ``graphs``: each step a replay of the
        captured step (default: on CUDA) or eager."""
        if model._train_dl is None and model.cfg.get("train_ds"):
            model.setup_training_data(model.cfg.train_ds)
        train_dl = model._train_dl
        if train_dl is None:
            raise ValueError("No training dataloader configured (model.cfg.train_ds)")
        accum, spe = self.accumulate_grad_batches, self.steps_per_execution
        group = accum if accum > 1 else spe  # batches a group; a group is one step under accumulation
        steps_per_epoch = max(len(train_dl) // accum, 1)
        if self.max_steps:
            max_steps = int(self.max_steps)
        elif self.max_epochs:
            max_steps = steps_per_epoch * int(self.max_epochs)
        else:
            raise ValueError("Either max_steps or max_epochs must be set")
        self._check_ported(model)

        state = self.init_state(model, max_steps)
        generator = torch.Generator(device=model.device).manual_seed(self.seed)
        hooks = self.exp_manager_hooks
        if self.posthoc_ema_sigma_rels:
            directory = self.posthoc_ema_dir or (str(hooks.log_dir / "phema") if hooks else "./phema")
            self.phema = PostHocEMA(directory, self.posthoc_ema_sigma_rels, self.posthoc_ema_every_n_steps,
                                    network=model.diffusion_model)
            state.phema = self.phema.init_state(state.params)
            log.info(f"Post-hoc EMA tracking sigma_rels={self.phema.sigma_rels} (gammas="
                     f"{tuple(round(g, 3) for g in self.phema.gammas)}), snapshots every {self.phema.every} "
                     f"steps -> {self.phema.dir}")
        epoch = 0
        if resume_state is not None:
            # Deterministic resume: the draws continue from the saved
            # generator state and the loader replays the stream from the
            # saved (epoch, batch) position.
            self._load_resume_state(state, generator, resume_state)
            epoch, offset = (int(v) for v in resume_state["data_position"])
            train_dl.set_position(epoch, offset)
            log.info(f"Resumed training from step {state.step}")
        start_step = state.step
        groups = ThreadedPrefetcher(_Groups(train_dl, group, stack=accum > 1), depth=2,
                                    pin=model.device.type == "cuda")
        save_every = int(model.save_and_sample_every or 0)
        n_batches = len(train_dl)

        def position():
            return self.checkpoint_state(state, generator, n_batches, group, 1 if accum > 1 else spe)

        log.info(f"Starting training: {max_steps} steps ({steps_per_epoch} steps/epoch, "
                 f"steps_per_execution={spe}, accum={accum})")
        trace = None
        t_last, samples_since, done = time.perf_counter(), 0, state.step >= max_steps
        while not done:
            for item in groups:
                if state.step >= max_steps:
                    done = True
                    break
                trace = self._profile_window(trace, state.step, model.device)
                prev = state.step
                if accum > 1:
                    data = item["audio"] if "audio" in item else item["image"]  # [K, B, ...]
                    draws = self.stack_draws([model.draw_training_inputs(data.shape[1:], generator)
                                              for _ in range(accum)])
                    metrics = self.train_step(model, state, item, draws, graphs=graphs)
                    samples_since += data.shape[0] * data.shape[1]
                    first = {k: v[0] for k, v in item.items()}
                else:
                    # A tail shorter than K runs the group's first steps singly.
                    for batch in item[: max_steps - prev]:
                        data = batch["audio"] if "audio" in batch else batch["image"]  # a vocoder: waveforms
                        draws = model.draw_training_inputs(data.shape, generator)
                        metrics = self.train_step(model, state, batch, draws, graphs=graphs)
                        samples_since += data.shape[0]
                    first = item[0]
                step = self.global_step = state.step
                if state.phema is not None:
                    self.phema.maybe_snapshot(state.phema, step)

                def crossed(cadence: int) -> bool:
                    return cadence > 0 and step // cadence > prev // cadence

                if crossed(self.log_every_n_steps) or step == max_steps:
                    host = {k: float(v) for k, v in metrics.items()}
                    if self.terminate_on_nan and not math.isfinite(host["train_loss"]):
                        raise FloatingPointError(f"Non-finite train_loss at step {step}: {host}")
                    now = time.perf_counter()
                    host["learning_rate"] = float(self.lr_schedule(step))
                    host["global_step"] = step
                    host["samples_per_sec"] = samples_since / max(now - t_last, 1e-9)
                    t_last, samples_since = now, 0
                    self.logged.append(host)
                    self._log_metrics(host, step)
                if save_every and crossed(save_every):
                    self._sample_dump(model, state, first, step)
                if hooks and hooks.should_checkpoint(step):
                    hooks.maybe_checkpoint(step, position(), metrics={"train_loss": float(metrics["train_loss"])})
            epoch += 1
            if self.max_epochs and epoch >= int(self.max_epochs) and not self.max_steps:
                done = True
        if trace is not None:
            self._stop_trace(trace, state.step)
        model.params = {k: v.detach() for k, v in state.params.items()}
        model.ema_params = state.ema_params
        if state.phema is not None and state.step > start_step:
            self.phema.snapshot(state.phema, state.step)  # the final profile time: reconstruct's default
        if hooks:
            hooks.finalize(model, position())
        log.info(f"Training finished at step {state.step}")

    def _profile_window(self, trace, step: int, device):
        """Open the ``profile_dir`` trace at ``profile_start_step`` and
        close it (written) at ``profile_start_step + profile_num_steps``, as
        the JAX trainer does before the step at those counts."""
        if not self.profile_dir:
            return trace
        if step == self.profile_start_step and trace is None:
            trace = WindowTrace(device, first_step=step)
            trace.start()
        if step == self.profile_start_step + self.profile_num_steps and trace is not None:
            self._stop_trace(trace, step)
            trace = None
        return trace

    def _stop_trace(self, trace, step: int) -> None:
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        path = Path(self.profile_dir) / f"trace-steps-{trace.first_step}-{step}.json"
        events = trace.stop(str(path))
        log.info(f"Profiler trace of steps {trace.first_step}-{step} ({len(events)} events) written to {path}")

    @staticmethod
    def _grouped(loader, k: int):
        """The loader's batches k at a time (lists); with k > 1 an epoch's
        trailing incomplete group is dropped (the JAX trainer's
        ``_accumulated``)."""
        group = []
        for batch in loader:
            group.append(batch)
            if len(group) == k:
                yield group
                group = []

    def _sample_dump(self, model, state: TrainState, batch, step: int) -> None:
        """The ``save_every`` services with the freshest weights (copies,
        so the model stays usable if the run stops): a sample grid, and
        bits/dim of the step's batch under ``compute_bpd``."""
        model.params = {k: v.detach().clone() for k, v in state.params.items()}
        model.ema_params = {k: v.clone() for k, v in state.ema_params.items()}
        imgs = model._save_image_step(batch_size=64, step=step)
        if imgs is not None and self.exp_manager_hooks:
            self.exp_manager_hooks.log_images("samples", imgs, step)
        if model.cfg.get("compute_bpd", False):
            x = preprocess_batch(batch, model.device)["pixel_values"]
            bpd = model.calculate_bits_per_dimension(x)
            self._log_metrics({"total_bits_per_dimension": float(bpd["total_bpd"].mean())}, step)

    # ------------------------------------------------------------------ test ----
    def test(self, model) -> Dict[str, float]:
        """Bits/dim over the test set (``limit_test_batches`` of it); batch
        i draws from a generator seeded with (seed, i)."""
        if model._test_dl is None and model.cfg.get("test_ds"):
            model.setup_test_data(model.cfg.test_ds)
        test_dl = model._test_dl
        if test_dl is None:
            raise ValueError("No test dataloader configured (model.cfg.test_ds)")
        max_batches = self._resolve_limit_batches(self.limit_test_batches, len(test_dl))
        outputs = []
        for i, batch in enumerate(ThreadedPrefetcher(test_dl, depth=2)):
            if i >= max_batches:
                break
            seed = int(np.random.SeedSequence([self.seed, i]).generate_state(1)[0])
            generator = torch.Generator(device=model.device).manual_seed(seed)
            outputs.append(model.test_step(batch, i, generator=generator))
        result = model.test_epoch_end(outputs)
        self._log_metrics(result, self.global_step)
        return result

    @staticmethod
    def _resolve_limit_batches(limit, n_batches: int) -> int:
        """PTL semantics: int = batch count, float in [0, 1] = fraction."""
        if limit is None:
            return n_batches
        if isinstance(limit, int) and not isinstance(limit, bool):
            return min(limit, n_batches)
        f = float(limit)
        if 0.0 <= f <= 1.0:
            return max(int(n_batches * f), 1) if f > 0 else 0
        return min(int(f), n_batches)

    def _log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self.exp_manager_hooks:
            self.exp_manager_hooks.log_metrics(metrics, step)
        else:
            log.info(f"step {step}: " + ", ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()))

    def _apply_precision(self, model) -> None:
        """The reference YAML ``trainer.precision``: 32 keeps the configured
        network dtype (bf16 for unet_small); 16/bf16 variants set bf16
        compute (parameters stay float32); anything else warns."""
        p = str(self.precision).lower().replace("-true", "").replace("-mixed", "")
        if p in ("32", "32.0", "none", "float32", "fp32"):
            return
        if p in ("16", "16.0", "bf16", "bfloat16", "fp16"):
            net_cfg = model.cfg.get("diffusion_model")
            if net_cfg is None or str(net_cfg.get("dtype", "float32")) in ("bfloat16", "bf16"):
                return
            net_cfg["dtype"] = "bfloat16"
            model.diffusion_model = model.build_network()
            log.info(f"trainer.precision={self.precision} -> network compute dtype bfloat16")
            return
        log.warning(f"trainer.precision={self.precision!r} is not supported; using the model's dtype")
