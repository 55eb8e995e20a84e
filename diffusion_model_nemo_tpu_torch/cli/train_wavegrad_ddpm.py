"""Train a WaveGrad-style DDPM (FiLM U-Net, continuous noise level) with the
port (counterpart of ``examples/wavegrad_ddpm/train_wavegrad_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_wavegrad_ddpm \\
        model.image_size=32 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/wavegrad_ddpm/
unet_small.yaml``. Each ``save_every`` dump samples on a searched 50-step
schedule, then (under the config's ``compute_bpd``) computes bits/dim on
the restored 1000-step one.
"""

from __future__ import annotations

from ..models import WavegradDDPM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/wavegrad_ddpm", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(WavegradDDPM, cfg)


if __name__ == "__main__":
    main()
