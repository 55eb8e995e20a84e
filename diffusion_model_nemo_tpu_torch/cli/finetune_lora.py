"""LoRA-fine-tune a trained archive with its base frozen (counterpart of
``examples/ddpm/finetune_lora.py``): low-rank adapters on the network's
kernels, a tiny ``.npz`` of them, and the merged archive.

    python -m diffusion_model_nemo_tpu_torch.cli.finetune_lora model_path=DDPM.dmn \\
        output_path=DDPM_lora.dmn rank=8 steps=2000 dataset_name=file file_dir=/data/new_domain

Any family whose step is ``training_step(params, batch, draws)``;
``adapters_path=`` also writes the raw adapters (readable by the JAX
package), ``merge=false`` skips the merged archive. The data is the
model's ``train_ds`` (``synthetic`` when it names none), or
``dataset_name`` (``file_dir`` its path). Each step is one captured graph on
the card (``training/lora.py``); ``devices`` other than 0 / 1 is not
ported. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch

from ..models import restore_model_from_archive
from ..modules.parts import not_ported
from ..training.lora import LoRAFinetuner
from .common import hydra_runner, training_batches

log = logging.getLogger(__name__)


@dataclass
class LoraConfig:
    model_path: str = "DDPM.dmn"
    output_path: str = "DDPM_lora.dmn"  # merged archive (merge=true)
    adapters_path: Optional[str] = None  # also save raw adapters (.npz)
    merge: bool = True
    use_ema: bool = True

    # adapters
    rank: int = 8
    alpha: Optional[float] = None  # defaults to rank (scale 1)
    targets: str = ".*"  # regex over '/'-joined kernel paths (e.g. "attn")

    # optimizer
    steps: int = 2000
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    # data (defaults to the base model's train_ds; synthetic needs no network)
    dataset_name: Optional[str] = None
    batch_size: int = 64
    dataset_length: int = 4096  # synthetic only
    file_dir: Optional[str] = None  # for dataset_name=file

    seed: int = 0
    log_every: int = 50
    devices: int = 1
    device: str = "cuda"


@hydra_runner(schema=LoraConfig)
def main(cfg):
    """Returns (the tuner, the logged losses, the merged model or None)."""
    cfg = LoraConfig(**cfg)
    if int(cfg.devices) not in (0, 1):
        raise not_ported("finetune_lora", f"devices={cfg.devices}", "parallelism")
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    log.info(f"LoRA fine-tuning {type(model).__name__} (rank={cfg.rank}, targets={cfg.targets!r}) for "
             f"{cfg.steps} steps")

    batches = training_batches(model, cfg)
    tuner = LoRAFinetuner(model, rank=cfg.rank, alpha=cfg.alpha, targets=cfg.targets,
                          learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip,
                          generator=torch.Generator().manual_seed(cfg.seed + 1))
    losses = tuner.finetune(batches, steps=cfg.steps,
                            generator=torch.Generator(device=model.device).manual_seed(cfg.seed),
                            log_every=cfg.log_every)
    if losses:
        log.info(f"LoRA loss: first {losses[0]:.5f} -> last {losses[-1]:.5f}")
    if cfg.adapters_path:
        log.info(f"Adapters saved to : {tuner.save_adapters(cfg.adapters_path)}")
    merged = None
    if cfg.merge:
        merged = tuner.merged_model()
        log.info(f"Merged archive saved to : {merged.save_to(cfg.output_path)}")
    return tuner, losses, merged


if __name__ == "__main__":
    main()
