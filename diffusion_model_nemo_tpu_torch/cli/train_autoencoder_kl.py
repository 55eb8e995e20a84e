"""Train the KL-autoencoder first stage of latent diffusion with the port
(counterpart of ``examples/latent_diffusion/train_autoencoder_kl.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_autoencoder_kl \\
        model.image_size=32 model.train_ds.name=cifar10 model.train_ds.split=train \\
        trainer.max_epochs=20 exp_manager.exp_dir=Experiments

Runs on ``cuda``; ``trainer.accelerator=cpu`` runs it on the CPU. Writes
``exp_dir/<name>/<version>/`` with the step checkpoints and the final
``AutoencoderKL.dmn``, the archive that ``train_latent_ddpm`` takes as
``model.first_stage.restore_from``.
"""

from __future__ import annotations

from ..models import AutoencoderKLModel
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/latent_diffusion", config_name="autoencoder_kl.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(AutoencoderKLModel, cfg)


if __name__ == "__main__":
    main()
