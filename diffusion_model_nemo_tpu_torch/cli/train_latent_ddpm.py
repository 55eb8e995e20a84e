"""Train a latent DDPM on a frozen AutoencoderKL first stage with the port
(counterpart of ``examples/latent_diffusion/train_latent_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_latent_ddpm \\
        model.image_size=32 model.first_stage.restore_from=AutoencoderKL.dmn \\
        model.diffusion_model.input_dim=8 model.train_ds.name=cifar10 \\
        model.train_ds.split=train trainer.max_epochs=20 exp_manager.exp_dir=Experiments

Under ``model.calibrate_scale_factor`` (the YAML's default) the latent scale
is set to 1 / std of the first training batch's posterior means before
``fit`` and kept in the archive's config. Runs on ``cuda``;
``trainer.accelerator=cpu`` runs it on the CPU. The final
``LatentDDPM.dmn`` carries the first stage (no autoencoder file is needed
to sample from it).
"""

from __future__ import annotations

import logging

from ..config.yaml_config import to_yaml
from ..models import LatentDiffusion
from ..training import Trainer, exp_manager
from .common import hydra_runner
from .train_ddpm import device_of

log = logging.getLogger(__name__)


@hydra_runner(config_path="examples/configs/latent_diffusion", config_name="latent_ddpm.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    log.info(f"Config:\n{to_yaml(cfg)}")
    trainer = Trainer(**cfg.trainer)
    hooks = exp_manager(trainer, cfg.get("exp_manager"))
    model = LatentDiffusion(cfg=cfg.model, device=device_of(cfg.trainer))
    model.maybe_init_from_pretrained_checkpoint(cfg)
    if bool(cfg.model.get("calibrate_scale_factor", False)):
        model.setup_training_data(cfg.model.train_ds)
        model.calibrate_scale_factor(next(iter(model._train_dl)))
    trainer.fit(model, resume_state=hooks.resume_state if hooks else None)
    return model, trainer


if __name__ == "__main__":
    main()
