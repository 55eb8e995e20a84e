"""Rectify (reflow) a rectified-flow archive into a one-to-few-step student
with the port (counterpart of
``examples/rectified_flow/reflow_rectified_flow.py``): retrain on the
model's own (noise, sample) couplings; no dataset.

    python -m diffusion_model_nemo_tpu_torch.cli.reflow_rectified_flow \\
        model_path=RF.dmn output_path=RF_1step.dmn steps=4000 batch_size=64 sample_steps=1

Restores with ``use_ema``, refuses archives of other families (as the JAX
script does) and ``devices`` other than 0 / 1 (not ported). Each step is
one captured graph on the card (``training/reflow.py``). ``device=cpu``
runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ..models import restore_model_from_archive
from ..modules.parts import not_ported
from ..training.reflow import ReflowTrainer
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class ReflowConfig:
    model_path: str = "RectifiedFlow.dmn"
    output_path: str = "RectifiedFlow_reflowed.dmn"
    use_ema: bool = True

    steps: int = 4000
    rounds: int = 1  # k-rectified flow: each round re-couples from the last
    batch_size: int = 64
    pair_steps: int = -1  # ODE steps for pair generation; -1 = the archive's sample_steps
    sample_steps: int = 1  # the packaged student's default NFE

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    seed: int = 0
    log_every: int = 50
    devices: int = 1
    device: str = "cuda"


@hydra_runner(schema=ReflowConfig)
def main(cfg):
    """Returns (the student model, the logged losses)."""
    cfg = ReflowConfig(**cfg)
    if int(cfg.devices) not in (0, 1):
        raise not_ported("reflow_rectified_flow", f"devices={cfg.devices}", "parallelism")
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if type(model).__name__ != "RectifiedFlow":
        raise ValueError(
            f"reflow applies to RectifiedFlow archives, got {type(model).__name__} "
            "(DDPM-family models distill via distill_ddpm.py / consistency_ddpm.py)"
        )
    log.info(f"Reflowing {type(model).__name__} ({cfg.rounds} round(s) x {cfg.steps} steps) "
             f"-> {cfg.sample_steps}-step student")
    trainer = ReflowTrainer(model, pair_steps=cfg.pair_steps if cfg.pair_steps > 0 else None,
                            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                            grad_clip=cfg.grad_clip)
    params, losses = trainer.reflow(steps=cfg.steps, batch_size=cfg.batch_size,
                                    generator=torch.Generator(device=model.device).manual_seed(cfg.seed),
                                    rounds=cfg.rounds, log_every=cfg.log_every)
    student = trainer.student_model(params, sample_steps=cfg.sample_steps)
    path = student.save_to(cfg.output_path)
    log.info(f"Reflowed student saved to : {path}")
    if losses:
        log.info(f"  loss: first {losses[0]:.5f} -> last {losses[-1]:.5f}")
    return student, losses


if __name__ == "__main__":
    main()
