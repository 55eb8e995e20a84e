"""Train the WaveGrad neural vocoder (mel → waveform) with the port
(counterpart of ``examples/wavegrad_ddpm/train_vocoder.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_vocoder trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/wavegrad_ddpm/
vocoder.yaml`` (24 kHz, hop 300, 80 mels, 7200-sample segments of the
synthetic audio set); the log-mel features are computed inside the step.
"""

from __future__ import annotations

from ..models import WavegradVocoderModel
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/wavegrad_ddpm", config_name="vocoder.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(WavegradVocoderModel, cfg)


if __name__ == "__main__":
    main()
