"""Sample from a WavegradDDPM archive with the port (counterpart of
``examples/wavegrad_ddpm/eval_wavegrad_ddpm.py``): a ``sample_timesteps``
schedule is searched (``search_iters`` candidates, seed 0) and the
ancestral chain runs on it; ``sample_timesteps=-1`` samples on the archive's
own schedule.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_wavegrad_ddpm \\
        model_path=Wavegrad-DDPM-UNet.dmn batch_size=32 sample_timesteps=50 seed=0

Writes ``samples_grid.png`` under ``output_dir`` (plus a timestamp
directory unless ``add_timestamp=false``). ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import WavegradDDPM
from ..utils.image import save_image_grid
from .common import hydra_runner
from .eval_ddpm import generator_of, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "WavegradDDPM.dmn"
    batch_size: int = 32
    image_size: int = -1
    sample_timesteps: int = 50
    search_iters: int = 1000

    output_dir: str = "samples"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = WavegradDDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.sample_timesteps > 0:
        model.sampler.use_searched_schedule(cfg.sample_timesteps, cfg.search_iters, seed=0)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    imgs = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg))
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=6)
    log.info(f"Saved {imgs.shape[0]} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
