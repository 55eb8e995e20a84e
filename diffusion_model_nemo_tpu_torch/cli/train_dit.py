"""Train a DDPM on the DiT backbone with the port (counterpart of
``examples/dit/train_dit.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_dit \\
        model.image_size=64 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

``train_ddpm``'s surface on ``examples/configs/dit/dit_small.yaml``; the
backbone is chosen by ``model.diffusion_model._target_`` alone, and
``model.num_classes`` picks the class-conditional family (as the JAX
script does).
"""

from __future__ import annotations

from ..models import DDPM, ConditionalDDPM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/dit", config_name="dit_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(ConditionalDDPM if cfg.model.get("num_classes") else DDPM, cfg)


if __name__ == "__main__":
    main()
