"""Train a text-conditional DiT DDPM with the port (counterpart of
``examples/dit/train_text_dit.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_text_dit \\
        model.image_size=64 model.train_ds.name=synthetic trainer.max_steps=20 \\
        exp_manager.exp_dir=Experiments

``train_ddpm``'s surface on ``examples/configs/dit/text_dit_small.yaml``:
the batches carry byte-tokenized captions (``train_ds.caption_len``; the
synthetic set's ``"a photo of class N"``, or ``name=file`` with
``+model.train_ds.path=<image directory>`` holding ``captions.txt``), and
``cond_drop_prob`` of them drop to the null context in training.
"""

from __future__ import annotations

from ..models import TextConditionalDDPM
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/dit", config_name="text_dit_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(TextConditionalDDPM, cfg)


if __name__ == "__main__":
    main()
