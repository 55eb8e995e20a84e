"""Train an EDM (Karras et al. 2022) model with the port (counterpart of
``examples/edm/train_edm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_edm \\
        model.image_size=32 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/edm/unet_small.yaml``.
``model.num_classes=K`` trains the class-conditional ``ConditionalEDM``
(joint conditional / unconditional training); ``+model.augment_prob=0.12
+model.diffusion_model.aug_dim=9`` turns on the non-leaky augmentation.
``trainer.accelerator=cpu`` runs it on the CPU.
"""

from __future__ import annotations

from ..models import EDM, ConditionalEDM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/edm", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(ConditionalEDM if cfg.model.get("num_classes") else EDM, cfg)


if __name__ == "__main__":
    main()
