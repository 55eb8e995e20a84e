"""Train a continuous score SDE with the port (counterpart of
``examples/score_sde/train_score_sde.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.train_score_sde \\
        model.image_size=32 model.train_ds.name=synthetic model.compute_bpd=false \\
        trainer.max_steps=20 exp_manager.exp_dir=Experiments

The same surface as ``train_ddpm`` on ``examples/configs/score_sde/vp/
unet_small.yaml`` (``model.sde.sde_type`` picks vpsde, subvpsde or vesde).
The shipped config sets ``compute_bpd: true``, with which the JAX script
fails at its first ``save_every`` dump (its bits/dim reads
``sampler.timesteps``); here the dump raises a ``ValueError`` that says so:
pass ``model.compute_bpd=false``.
"""

from __future__ import annotations

from ..models import ScoreSDE
from .common import hydra_runner
from .train_ddpm import train


@hydra_runner(config_path="examples/configs/score_sde/vp", config_name="unet_small.yaml")
def main(cfg):
    """Returns (model, trainer) after ``fit``."""
    return train(ScoreSDE, cfg)


if __name__ == "__main__":
    main()
