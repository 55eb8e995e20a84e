"""Train a rectified-flow / flow-matching model with the port (counterpart
of ``examples/rectified_flow/train_rectified_flow.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_rectified_flow \\
        model.image_size=32 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on
``examples/configs/rectified_flow/unet_small.yaml``
(``model.sampler.time_sampling=logit_normal`` for SD3-style times).
``trainer.accelerator=cpu`` runs it on the CPU.
"""

from __future__ import annotations

from ..models import RectifiedFlow
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/rectified_flow", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(RectifiedFlow, cfg)


if __name__ == "__main__":
    main()
