"""Train an SR3 super-resolution model with the port (counterpart of
``examples/sr3/train_sr3.py``): (LR, HR) pairs are made inside the step
from any image dataset (shrink, then upsample back).

    python -m diffusion_model_nemo_tpu_torch.cli.train_sr3 \\
        model.image_size=32 model.scale_factor=4 \\
        model.train_ds.name=file +model.train_ds.path=images.npz \\
        trainer.max_steps=20 exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/sr3/unet_small.yaml``
(``model.image_size`` has no default there). ``+model.cond_aug_std=s`` adds
the conditioning augmentation; ``trainer.accelerator=cpu`` runs it on the
CPU.
"""

from __future__ import annotations

from ..models import SR3
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/sr3", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(SR3, cfg)


if __name__ == "__main__":
    main()
