"""Training loop on one device, and the dataset test loop.

Counterpart of ``diffusion_model_nemo_tpu/training/trainer.py`` (``fit``,
``test``, ``_build_update_fn``, ``_apply_precision``,
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
global norm, clip, AdamW, EMA), and every later step copies its batch, its
draws and its rows of the optimizer's and the EMA's scalar tables
(``optim.py``, ``ema.py``; grown on the host as the steps go on) into the
graph's static buffers and replays it. ``steps_per_execution = K`` runs K steps
between host syncs, as the JAX trainer's multi-step dispatch does: logging,
the sample dump and the NaN check quantize to K-step boundaries (JAX's
``_crossed`` rule), checkpoints keep ``step % checkpoint_every_n_steps``,
an epoch's batches go in groups of K (a trailing incomplete group is
dropped) and a tail shorter than K runs single steps.

Services, as in the JAX trainer: the ``save_every`` sample dump (and
bits/dim of the step's batch under ``compute_bpd``), the ``exp_manager``
hooks (metrics, image logging, checkpoints every
``checkpoint_every_n_steps``, the final archive), and resume from a
checkpoint's state: params, EMA, optimizer state, step, the draw
generator's state and the data position, so that a resumed run is
bit-identical to an uninterrupted one. The draws come from one
``torch.Generator`` seeded with ``seed`` (the JAX package derives a key per
step instead; the two streams differ, the resume contract is the same).

Options of the JAX trainer that would change the run and are not ported
raise at ``fit`` start: gradient accumulation (``steps_per_execution`` > 1
beside it falls back to single steps with a warning first, as in the JAX
trainer), post-hoc EMA, any strategy but one device, the profiler, PTL's
``resume_from_checkpoint`` and ``enable_checkpointing`` (exp_manager resumes
and checkpoints).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.hf_vision_data import preprocess_batch
from ..modules.parts import not_ported
from ..ops import graphs as graphs_lib
from .ema import ema_decay_table, ema_update, init_ema
from .optim import Optimizer, build_optimizer, global_norm

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
    it goes with the state."""

    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int = 0
    graphs: Dict[tuple, Any] = field(default_factory=dict)


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
        terminate_on_nan: bool = True,
        posthoc_ema_sigma_rels: Optional[Any] = None,
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
        self.gradient_clip_val = gradient_clip_val
        self.precision = precision
        self.log_every_n_steps = int(log_every_n_steps)
        self.ema_decay = float(ema_decay)
        self.seed = int(seed)
        self.strategy = strategy
        self.profile_dir = profile_dir
        self.terminate_on_nan = bool(terminate_on_nan)
        self.posthoc_ema_sigma_rels = posthoc_ema_sigma_rels
        self.limit_test_batches = limit_test_batches
        self.resume_from_checkpoint = resume_from_checkpoint
        self.enable_checkpointing = bool(enable_checkpointing)
        self.global_step = 0
        self.exp_manager_hooks = None  # set by exp_manager()
        self.optimizer: Optional[Optimizer] = None
        self.lr_schedule = None
        self._tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # the optimizer's, the EMA's
        self.logged: List[Dict[str, float]] = []  # the metrics of each logging step

    # ------------------------------------------------------------------ fit ----
    def _check_ported(self, model) -> None:
        def refuse(option: str):
            raise not_ported("Trainer", option, "training services")

        if self.accumulate_grad_batches > 1:
            refuse(f"accumulate_grad_batches={self.accumulate_grad_batches}")
        if self.posthoc_ema_sigma_rels:
            refuse("posthoc_ema_sigma_rels")
        strategy = None if self.strategy is None else str(self.strategy).lower()
        n = int(self.devices)
        if n in (-1, 0):
            n = torch.cuda.device_count() if model.device.type == "cuda" else 1
        if strategy not in _ONE_DEVICE_STRATEGIES or n > 1 or int(self.num_nodes) > 1:
            refuse(f"strategy={self.strategy!r} on {n} device(s) x {self.num_nodes} node(s)")
        if self.resume_from_checkpoint:
            refuse("resume_from_checkpoint (resume through exp_manager.resume_if_exists)")
        if self.profile_dir:
            refuse("profile_dir")
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

    def _build_tables(self, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.optimizer.table(n, device), ema_decay_table(self.ema_decay, n, device)

    def _scalars(self, state: TrainState, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rows of the optimizer's and the EMA's tables for the next
        step. A table has no end: when a step passes its last row, both are
        built anew over twice its count, on the host between steps (a graph
        copies its rows into static buffers and never reads a table)."""
        count, step = state.opt_state["count"], state.step
        if max(count, step) >= self._tables[0].shape[0]:
            self._tables = self._build_tables(2 * max(count, step), device)
        return self._tables[0][count], self._tables[1][step]

    def train_step(self, model, state: TrainState, batch, draws,
                   graphs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``state``, in place; returns the step's
        metrics as device tensors (``train_loss``, ``grad_norm``).
        ``graphs``: replay the state's captured step (default: on CUDA; the
        first step of a state runs eagerly and is captured) or run it
        eagerly. Either way the same ``_step``."""
        scalars = self._scalars(state, model.device)
        if graphs_lib.use_graphs(graphs, model.device):
            metrics = self._replayed_step(model, state, batch, draws, scalars)
        else:
            metrics = self._step(model, state, batch, draws, scalars)
        state.step += 1
        state.opt_state["count"] += 1
        return metrics

    def _step(self, model, state: TrainState, batch, draws, scalars) -> Dict[str, torch.Tensor]:
        """The step itself, device work only (the captured function):
        loss, gradients, global norm, clip + update, EMA. ``scalars``: the
        optimizer's and the EMA's rows (``_scalars``)."""
        loss, metrics = model.training_step(state.params, batch, draws)
        grads = param_grads(loss, state.params, getattr(model.diffusion_model, "unused_params", frozenset()))
        with torch.no_grad():
            norm = global_norm(grads)
            self.optimizer.step(state.params, grads, state.opt_state, grad_norm=norm, scalars=scalars[0])
            ema_update(state.ema_params, state.params, scalars[1])
        return {k: v.detach() for k, v in metrics.items()} | {"grad_norm": norm}

    def _replayed_step(self, model, state: TrainState, batch, draws, scalars) -> Dict[str, torch.Tensor]:
        """``_step`` as a replay of the state's graph: the batch's image and
        labels (through pinned memory on CUDA: a pageable copy cannot
        overlap), the draws and the step's scalars go into its static
        buffers first. Captured with the derived-weights
        cache off: the prenorm folds, casts and re-layouts of the changing
        weights are recomputed at every replay."""
        host = {}  # the batch's arrays: the image or the waveform, and the labels where the batch has them
        for k in ("image", "audio", "label"):
            if k in batch:
                v = batch[k]
                v = v if torch.is_tensor(v) else torch.as_tensor(np.ascontiguousarray(v))
                if model.device.type == "cuda" and v.device.type == "cpu":
                    v = v.pin_memory()
                host[k] = v

        inputs = {**draws, "opt": scalars[0], "ema": scalars[1]}

        def stage(static):
            for k, v in host.items():
                static[k].copy_(v, non_blocking=True)
            for k, v in inputs.items():
                static[k].copy_(v)

        def build():
            dev = model.device
            static = {**{k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v in host.items()},
                      **{k: torch.empty_like(v, device=dev) for k, v in inputs.items()}}
            stage(static)

            def step():
                return self._step(model, state, {k: static[k] for k in host},
                                  {k: static[k] for k in draws}, (static["opt"], static["ema"]))

            return graphs_lib.Graph("train_step", step, static, device=dev, warmup=step, mutates=writes,
                                    derived=False)

        writes = [*state.params.values(), *state.ema_params.values()]
        moments = [v for d in state.opt_state.values() if isinstance(d, dict) for v in d.values()]
        key = ("train_step", *((k, tuple(v.shape), v.dtype) for k, v in {**host, **draws}.items()))
        tables = getattr(model.sampler, "table_tensors", tuple)()  # q_sample's, the noise level's
        graph, built = graphs_lib.cached(state.graphs, key, [*writes, *moments, *tables], build)
        if built:
            out = graph.warmup_out
        else:
            stage(graph.static)
            out = graph.replay()
        return {k: v.clone() for k, v in out.items()}

    @staticmethod
    def checkpoint_state(state: TrainState, generator: torch.Generator, steps_per_epoch: int,
                         group: int = 1) -> Dict[str, Any]:
        """What a resume needs (tensors still on the device: the checkpoint
        manager copies them to the CPU). The data position is where the
        loader stands after ``state.step`` steps taken ``group`` batches at
        a time (an epoch's trailing incomplete group dropped; the JAX
        trainer's fast-forward rule)."""
        groups, per_epoch = state.step // group, max(steps_per_epoch // group, 1)
        return {
            "params": {k: v.detach() for k, v in state.params.items()},
            "ema_params": state.ema_params,
            "opt_state": state.opt_state,
            "step": state.step,
            "generator": generator.get_state(),
            "data_position": [groups // per_epoch, (groups % per_epoch) * group],
        }

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
        steps_per_epoch = max(len(train_dl), 1)
        if self.max_steps:
            max_steps = int(self.max_steps)
        elif self.max_epochs:
            max_steps = steps_per_epoch * int(self.max_epochs)
        else:
            raise ValueError("Either max_steps or max_epochs must be set")
        self._check_ported(model)

        state = self.init_state(model, max_steps)
        generator = torch.Generator(device=model.device).manual_seed(self.seed)
        epoch = 0
        if resume_state is not None:
            # Deterministic resume: the draws continue from the saved
            # generator state and the loader replays the stream from the
            # saved (epoch, batch) position.
            self._load_resume_state(state, generator, resume_state)
            epoch, offset = (int(v) for v in resume_state["data_position"])
            train_dl.set_position(epoch, offset)
            log.info(f"Resumed training from step {state.step}")
        hooks = self.exp_manager_hooks
        save_every = int(model.save_and_sample_every or 0)
        spe = self.steps_per_execution
        log.info(f"Starting training: {max_steps} steps ({steps_per_epoch} steps/epoch, "
                 f"steps_per_execution={spe})")
        t_last, samples_since, done = time.perf_counter(), 0, state.step >= max_steps
        while not done:
            for group in self._grouped(train_dl, spe):
                if state.step >= max_steps:
                    done = True
                    break
                # A tail shorter than K runs the group's first steps singly.
                prev = state.step
                for batch in group[: max_steps - prev]:
                    data = batch["audio"] if "audio" in batch else batch["image"]  # a vocoder trains on waveforms
                    draws = model.draw_training_inputs(data.shape, generator)
                    metrics = self.train_step(model, state, batch, draws, graphs=graphs)
                    samples_since += data.shape[0]
                step = self.global_step = state.step

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
                    self._sample_dump(model, state, group[0], step)
                if hooks and hooks.should_checkpoint(step):
                    hooks.maybe_checkpoint(
                        step, self.checkpoint_state(state, generator, steps_per_epoch, spe),
                        metrics={"train_loss": float(metrics["train_loss"])},
                    )
            epoch += 1
            if self.max_epochs and epoch >= int(self.max_epochs) and not self.max_steps:
                done = True
        model.params = {k: v.detach() for k, v in state.params.items()}
        model.ema_params = state.ema_params
        if hooks:
            hooks.finalize(model, self.checkpoint_state(state, generator, steps_per_epoch, spe))
        log.info(f"Training finished at step {state.step}")

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
        for i, batch in enumerate(test_dl):
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
