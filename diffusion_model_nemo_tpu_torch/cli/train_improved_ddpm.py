"""Train an Improved DDPM (learned variance, hybrid loss) with the port
(counterpart of ``examples/improved_ddpm/train_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_improved_ddpm \\
        model.image_size=32 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/improved_ddpm/
unet_small.yaml``; the logged metrics add ``simple_loss``, ``vb_losses`` and
``decoder_nll``.
"""

from __future__ import annotations

from ..models import ImprovedDDPM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/improved_ddpm", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(ImprovedDDPM, cfg)


if __name__ == "__main__":
    main()
