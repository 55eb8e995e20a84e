"""Sample from a LatentDiffusion archive with the port (counterpart of
``examples/latent_diffusion/eval_latent_ddpm.py``): the latent chain with
DDIM (default), DPM-Solver++ or the model's own ancestral chain, then the
archive's own first stage decodes.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_latent_ddpm model_path=LatentDDPM.dmn \\
        batch_size=16 use_ddim_sampler=true ddim_timesteps=50
    ... use_dpm_solver=true dpm_steps=20          # overrides DDIM

Writes ``sample_<i>.png`` and ``samples_grid.png`` under ``output_dir``
(plus a timestamp directory unless ``add_timestamp=false``). ``device=cpu``
runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import LatentDiffusion
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, maybe_use_ddim_sampler, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "LatentDDPM.dmn"
    batch_size: int = 32
    image_size: int = -1

    # DDIM
    use_ddim_sampler: bool = True
    ddim_eta: float = 0.0
    ddim_timesteps: int = 50  # -1 uses original timesteps

    # DPM-Solver++ (overrides DDIM when set)
    use_dpm_solver: bool = False
    dpm_steps: int = 20
    dpm_order: int = 2
    dpm_time_spacing: str = "strided"

    # Output
    output_dir: str = "samples"
    add_timestamp: bool = True
    grid_plot: bool = True

    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = LatentDiffusion.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    maybe_use_ddim_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    imgs = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg))
    imgs = imgs.float().cpu().numpy()

    out_dir = output_dir(cfg)
    if cfg.grid_plot:
        save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=6)
    for i, img in enumerate(to_uint8(imgs)):
        (out_dir / f"sample_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {imgs.shape[0]} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
