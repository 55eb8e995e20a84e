"""Sample from an ImprovedDDPM archive with the port (counterpart of
``examples/improved_ddpm/eval_ddpm.py``): the model's own ancestral chain
with the learned variance (default), or DDIM, which refuses a
learned-variance network's output as the JAX package's DDIM step does.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_improved_ddpm \\
        model_path=ImprovedDDPM.dmn batch_size=16 seed=0

Writes ``samples_grid.png`` under ``output_dir`` (plus a timestamp
directory unless ``add_timestamp=false``). ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import ImprovedDDPM
from ..utils.image import save_image_grid
from .common import hydra_runner
from .eval_ddpm import generator_of, maybe_use_ddim_sampler, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "ImprovedDDPM.dmn"
    batch_size: int = 32
    image_size: int = -1
    use_ddim_sampler: bool = False
    ddim_eta: float = 0.0
    ddim_timesteps: int = 50

    output_dir: str = "samples"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = ImprovedDDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    maybe_use_ddim_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    imgs = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg))
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=6)
    log.info(f"Saved {imgs.shape[0]} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
