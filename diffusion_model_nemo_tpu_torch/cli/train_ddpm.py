"""Train a DDPM with the port (counterpart of ``examples/ddpm/train_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_ddpm \\
        --config-path=examples/configs/ddpm --config-name=unet_small.yaml \\
        model.image_size=32 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

Runs on ``cuda``; ``trainer.accelerator=cpu`` runs it on the CPU (the
kernels' plain versions). Writes ``exp_dir/<name>/<version>/`` with
``hparams.yaml``, the step checkpoints and the final ``<name>.dmn``;
``exp_manager.resume_if_exists=true`` with ``+exp_manager.version=<v>``
continues the run of that version (without a version every run makes a new
datetime directory, as in the JAX package).
"""

from __future__ import annotations

import logging

from ..config.yaml_config import to_yaml
from ..models import DDPM
from ..training import Trainer, exp_manager
from .common import hydra_runner

log = logging.getLogger(__name__)


def device_of(trainer_cfg) -> str:
    """The PTL ``trainer.accelerator`` key: ``cpu``, or the card for
    ``auto`` / ``gpu`` / ``cuda`` (the port never falls back to the CPU)."""
    accelerator = str(trainer_cfg.get("accelerator") or "auto").lower()
    if accelerator == "cpu":
        return "cpu"
    if accelerator in ("auto", "gpu", "cuda"):
        return "cuda"
    raise ValueError(f"trainer.accelerator={accelerator!r}: the port runs on cpu or cuda")


def train(model_class, cfg):
    """The train scripts' body for ``model_class``: returns (model, trainer)
    after ``fit``."""
    log.info(f"Config:\n{to_yaml(cfg)}")
    trainer = Trainer(**cfg.trainer)
    hooks = exp_manager(trainer, cfg.get("exp_manager"))
    model = model_class(cfg=cfg.model, device=device_of(cfg.trainer))
    model.maybe_init_from_pretrained_checkpoint(cfg)
    trainer.fit(model, resume_state=hooks.resume_state if hooks else None)
    return model, trainer


@hydra_runner(config_path="examples/configs/ddpm", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(DDPM, cfg)


if __name__ == "__main__":
    main()
