"""Consistency-distill a DDPM-family archive into a one-to-few-step student
with the port (counterpart of ``examples/ddpm/consistency_ddpm.py``; Song et
al. 2023): one run teaches the ODE-jump-to-data map, so the student samples
in ``sample_steps`` network calls.

    python -m diffusion_model_nemo_tpu_torch.cli.consistency_ddpm model_path=DDPM.dmn \\
        output_path=DDPM_cd.dmn steps=4000 grid_steps=18 sample_steps=1 \\
        dataset_name=synthetic batch_size=64

``mode=train`` is consistency training (CT: no teacher call);
``teacher_order=1`` takes Euler steps. The data is the archive's
``train_ds`` (``synthetic`` when it names none), or ``dataset_name``
(``file_dir`` its path). Each step is one captured graph on the card
(``training/consistency.py``); ``devices`` other than 0 / 1 is not ported.
``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch

from ..models import restore_model_from_archive
from ..modules.parts import not_ported
from ..training.consistency import ConsistencyDistiller
from .common import hydra_runner, training_batches

log = logging.getLogger(__name__)


@dataclass
class ConsistencyConfig:
    model_path: str = "DDPM.dmn"
    output_path: str = "DDPM_consistency.dmn"
    use_ema: bool = True

    # distillation
    steps: int = 4000
    grid_steps: int = 18  # N discretization levels (Karras rho-grid)
    rho: float = 7.0
    sigma_min: Optional[float] = None  # default: the schedule's own endpoints
    sigma_max: Optional[float] = None
    sigma_data: float = 0.5
    ema_decay: float = 0.95  # target-network mu
    loss: str = "l2"  # l2 | pseudo_huber
    teacher_order: int = 2  # Heun (paper) | 1 = Euler
    mode: str = "distill"  # distill (CD) | train (CT, no teacher evals)

    # packaged student
    sample_steps: int = 1  # NFE of the packaged sampler

    # optimizer
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    # data (defaults to the teacher's train_ds; synthetic needs no network)
    dataset_name: Optional[str] = None
    batch_size: int = 64
    dataset_length: int = 4096  # synthetic only
    file_dir: Optional[str] = None  # for dataset_name=file

    seed: int = 0
    log_every: int = 50
    devices: int = 1
    device: str = "cuda"


@hydra_runner(schema=ConsistencyConfig)
def main(cfg):
    """Returns (the student model, the logged losses)."""
    cfg = ConsistencyConfig(**cfg)
    if int(cfg.devices) not in (0, 1):
        raise not_ported("consistency_ddpm", f"devices={cfg.devices}", "parallelism")
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    log.info(f"Consistency-distilling {type(model).__name__} (T={model.timesteps}, "
             f"objective={model.sampler.objective}) -> {cfg.sample_steps}-step student")
    batches = training_batches(model, cfg)
    distiller = ConsistencyDistiller(model, grid_steps=cfg.grid_steps, rho=cfg.rho, sigma_min=cfg.sigma_min,
                                     sigma_max=cfg.sigma_max, sigma_data=cfg.sigma_data, ema_decay=cfg.ema_decay,
                                     learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                                     grad_clip=cfg.grad_clip, loss=cfg.loss, teacher_order=cfg.teacher_order,
                                     mode=cfg.mode)
    params, losses = distiller.distill(batches, steps=cfg.steps,
                                       generator=torch.Generator(device=model.device).manual_seed(cfg.seed),
                                       log_every=cfg.log_every)
    student = distiller.student_model(params, sample_steps=cfg.sample_steps)
    log.info(f"Consistency student saved to : {student.save_to(cfg.output_path)}")
    if losses:
        log.info(f"  loss: first {losses[0]:.5f} -> last {losses[-1]:.5f}")
    return student, losses


if __name__ == "__main__":
    main()
