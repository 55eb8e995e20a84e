"""Experiment manager: the log directory, TensorBoard/W&B logging, step
checkpoints, resume and the final archive.

Counterpart of ``diffusion_model_nemo_tpu/training/exp_manager.py`` (NeMo's
``exp_manager``, configured by the YAML ``exp_manager`` block): creates
``exp_dir/name/version``, writes ``hparams.yaml``, attaches a TensorBoard
writer (``torch.utils.tensorboard``) and a wandb run where those packages
import (else one warning each, and the run goes on), wires checkpoints every
``checkpoint_every_n_steps`` into the Trainer, honours ``resume_if_exists``
/ ``resume_ignore_no_checkpoint``, and saves the final ``<name>.dmn``
(``always_save_nemo``).

Without a ``version`` every run makes a new datetime directory
(``version_0`` under ``use_datetime_version: false``), as the JAX package
does, so ``resume_if_exists`` resumes the run of the ``version`` it is
given.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Any, Dict, Optional

from ..config.yaml_config import Config, from_dict, to_yaml
from .checkpoints import CheckpointManager

__all__ = ["exp_manager", "ExpManagerHooks"]

log = logging.getLogger(__name__)


class ExpManagerHooks:
    def __init__(self, log_dir: Path, cfg: Config, model_name: str):
        self.log_dir = log_dir
        self.cfg = cfg
        self.model_name = model_name
        self.tb_writer = None
        self.wandb_run = None
        self.ckpt_mgr: Optional[CheckpointManager] = None
        self.resume_state: Optional[Dict[str, Any]] = None
        self.ckpt_every = int(cfg.get("checkpoint_every_n_steps", 1000))
        ckpt_params = cfg.get("checkpoint_callback_params") or {}
        self.always_save_archive = bool(ckpt_params.get("always_save_nemo", True))

        if cfg.get("create_tensorboard_logger", True):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                log.warning(f"TensorBoard logger unavailable: {e}")
            else:
                self.tb_writer = SummaryWriter(log_dir=str(log_dir / "tensorboard"))
        if cfg.get("create_wandb_logger", False):
            try:
                import wandb
            except ImportError as e:
                log.warning(f"wandb logger unavailable: {e}")
            else:
                self.wandb_run = wandb.init(dir=str(log_dir), **dict(cfg.get("wandb_logger_kwargs") or {}))
        if cfg.get("create_checkpoint_callback", True):
            self.ckpt_mgr = CheckpointManager(
                str(log_dir / "checkpoints"),
                max_to_keep=int(ckpt_params.get("save_top_k", 1)),
                monitor=ckpt_params.get("monitor", "train_loss"),
                mode=ckpt_params.get("mode", "min"),
                save_interval_steps=self.ckpt_every,
            )

    # ---- Trainer-facing hooks ------------------------------------------------
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        scalars = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        if self.tb_writer:
            for k, v in scalars.items():
                self.tb_writer.add_scalar(k, v, step)
        if self.wandb_run:
            self.wandb_run.log(scalars, step=step)
        log.info(f"step {step}: " + ", ".join(f"{k}={v:.5g}" for k, v in scalars.items()))

    def log_images(self, tag: str, images, step: int) -> None:
        """A sample grid ([B, H, W, C] in [0, 1]) to TensorBoard / wandb.
        The TensorBoard image summary carries the port's own PNG encoding
        (``add_image`` would import Pillow to encode it)."""
        from ..utils.image import encode_png, make_grid

        grid = make_grid(images, nrow=6)
        if self.tb_writer:
            from tensorboard.compat.proto.summary_pb2 import Summary

            h, w, c = grid.shape
            image = Summary.Image(height=h, width=w, colorspace=c, encoded_image_string=encode_png(grid))
            self.tb_writer._get_file_writer().add_summary(Summary(value=[Summary.Value(tag=tag, image=image)]), step)
        if self.wandb_run:
            import wandb

            self.wandb_run.log({tag: wandb.Image(grid)}, step=step)

    def should_checkpoint(self, step: int) -> bool:
        """The one source of the save cadence; the Trainer asks before it
        reads the monitored metric back from the device."""
        return bool(self.ckpt_mgr) and step % self.ckpt_every == 0

    def maybe_checkpoint(self, step: int, state: Dict[str, Any], metrics=None) -> None:
        if self.should_checkpoint(step):
            self.ckpt_mgr.save(step, state, metrics=metrics)

    def finalize(self, model, state: Dict[str, Any]) -> None:
        if self.ckpt_mgr:
            self.ckpt_mgr.save(int(state["step"]), state, force=True)
            self.ckpt_mgr.wait()
        if self.always_save_archive:
            path = str(self.log_dir / f"{self.model_name}.dmn")
            model.save_to(path)
            log.info(f"Final model archive saved to {path}")
        if self.tb_writer:
            self.tb_writer.flush()

    # ---- resume ------------------------------------------------------------------
    def try_resume(self) -> Optional[Dict[str, Any]]:
        if self.ckpt_mgr is None:
            return None
        step = self.ckpt_mgr.latest_step()
        if step is None:
            return None
        log.info(f"Found checkpoint at step {step}; resuming")
        return self.ckpt_mgr.restore(step)


def exp_manager(trainer, cfg) -> Optional[ExpManagerHooks]:
    """Attach experiment management to a Trainer; returns the hooks (or None)."""
    if cfg is None:
        return None
    cfg = from_dict(cfg)
    exp_dir = cfg.get("exp_dir") or "./nemo_experiments"
    name = cfg.get("name") or "default"
    version = cfg.get("version")
    if version is None:
        use_dt = cfg.get("use_datetime_version", True)
        version = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S") if use_dt else "version_0"
    log_dir = Path(exp_dir).absolute() / name / str(version)
    log_dir.mkdir(parents=True, exist_ok=True)

    hooks = ExpManagerHooks(log_dir, cfg, model_name=name)
    trainer.exp_manager_hooks = hooks
    (log_dir / "hparams.yaml").write_text(to_yaml(cfg))
    log.info(f"Experiment directory : {log_dir}")

    if cfg.get("resume_if_exists", False):
        hooks.resume_state = hooks.try_resume()
        if hooks.resume_state is None and not cfg.get("resume_ignore_no_checkpoint", False):
            log.warning("resume_if_exists=True but no checkpoint found")
    return hooks
