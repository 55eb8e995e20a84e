"""Progressively distill a DDPM-family archive into a few-step DDIM student
with the port (counterpart of ``examples/ddpm/distill_ddpm.py``; Salimans &
Ho 2022): the objective transfer, then halving phases T/2, T/4, … down to
``final_steps``.

    python -m diffusion_model_nemo_tpu_torch.cli.distill_ddpm model_path=DDPM.dmn \\
        output_path=DDPM_distilled.dmn final_steps=125 steps_per_phase=2000 transfer_steps=1000 \\
        dataset_name=synthetic batch_size=64

``guidance_scale`` (a ConditionalDDPM archive and labeled data) makes the
student absorb the guided combination at that w into one call. The data is
the archive's ``train_ds`` (``synthetic`` when it names none), or
``dataset_name`` (``file_dir`` its path). Each step is one captured graph on
the card (``training/distillation.py``); ``devices`` other than 0 / 1 is
not ported. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch

from ..models import restore_model_from_archive
from ..modules.parts import not_ported
from ..training.distillation import ProgressiveDistiller
from .common import hydra_runner, training_batches

log = logging.getLogger(__name__)


@dataclass
class DistillConfig:
    model_path: str = "DDPM.dmn"
    output_path: str = "DDPM_distilled.dmn"
    use_ema: bool = True

    # distillation schedule
    final_steps: int = 125  # halving target: T/2, T/4, ... down to this
    steps_per_phase: int = 2000
    transfer_steps: int = 1000  # eps->v re-parameterization steps (0 if same objective)
    student_objective: str = "pred_v"  # pred_v | pred_noise | pred_x0

    # optimizer
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    loss_weighting: str = "truncated_snr"  # truncated_snr | uniform

    # guidance distillation (ConditionalDDPM teachers and labeled data only)
    guidance_scale: Optional[float] = None

    # data (defaults to the teacher's train_ds; synthetic needs no network)
    dataset_name: Optional[str] = None
    batch_size: int = 64
    dataset_length: int = 4096  # synthetic only
    file_dir: Optional[str] = None  # for dataset_name=file

    seed: int = 0
    log_every: int = 50
    devices: int = 1
    device: str = "cuda"


@hydra_runner(schema=DistillConfig)
def main(cfg):
    """Returns (the student model, the losses by phase)."""
    cfg = DistillConfig(**cfg)
    if int(cfg.devices) not in (0, 1):
        raise not_ported("distill_ddpm", f"devices={cfg.devices}", "parallelism")
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    log.info(f"Distilling {type(model).__name__} (T={model.timesteps}, objective={model.sampler.objective}) -> "
             f"{cfg.final_steps}-step {cfg.student_objective} student")
    batches = training_batches(model, cfg)
    distiller = ProgressiveDistiller(model, student_objective=cfg.student_objective,
                                     learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                                     grad_clip=cfg.grad_clip, loss_weighting=cfg.loss_weighting,
                                     guidance_scale=cfg.guidance_scale)
    transfer = cfg.transfer_steps if cfg.student_objective != model.sampler.objective else 0
    params, history = distiller.distill(batches, final_steps=cfg.final_steps, steps_per_phase=cfg.steps_per_phase,
                                        generator=torch.Generator(device=model.device).manual_seed(cfg.seed),
                                        transfer_steps=transfer, log_every=cfg.log_every)
    student = distiller.student_model(params, student_steps=cfg.final_steps)
    log.info(f"Distilled student saved to : {student.save_to(cfg.output_path)}")
    for phase, losses in history.items():
        if losses:
            log.info(f"  phase {phase}: first {losses[0]:.5f} -> last {losses[-1]:.5f}")
    return student, history


if __name__ == "__main__":
    main()
