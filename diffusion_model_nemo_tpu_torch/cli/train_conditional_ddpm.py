"""Train a class-conditional DDPM with the port (counterpart of
``examples/conditional_ddpm/train_conditional_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_conditional_ddpm \\
        model.image_size=32 model.num_classes=10 model.train_ds.name=synthetic \\
        trainer.max_steps=20 exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/conditional_ddpm/
unet_small.yaml`` (``model.num_classes`` is required; the synthetic set
yields labels in [0, num_classes)).
"""

from __future__ import annotations

from ..models import ConditionalDDPM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/conditional_ddpm", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(ConditionalDDPM, cfg)


if __name__ == "__main__":
    main()
