"""Class-conditional sampling from a ConditionalDDPM archive with the port
(counterpart of ``examples/conditional_ddpm/eval_conditional_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.eval_conditional_ddpm \\
        model_path=ConditionalDDPM.dmn label=3 guidance_scale=3.0 batch_size=16

``label`` (None = the null class) and ``guidance_scale`` (classifier-free
guidance; needs a label). DDIM-10 by default. Writes
``samples_class<label>.png`` (``samples_uncond.png`` without a label) under
``output_dir``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import ConditionalDDPM
from ..utils.image import save_image_grid
from .common import hydra_runner
from .eval_ddpm import generator_of, maybe_use_ddim_sampler, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "ConditionalDDPM.dmn"
    batch_size: int = 32
    image_size: int = -1
    label: Optional[int] = None  # None = unconditional (null class)
    guidance_scale: Optional[float] = None  # needs a label; 1 = conditional

    use_ddim_sampler: bool = True
    ddim_eta: float = 0.0
    ddim_timesteps: int = 10

    output_dir: str = "samples"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = ConditionalDDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    maybe_use_ddim_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    imgs = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg),
                        label=cfg.label, guidance_scale=cfg.guidance_scale)
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    tag = "uncond" if cfg.label is None else f"class{cfg.label}"
    save_image_grid(imgs, str(out_dir / f"samples_{tag}.png"), nrow=6)
    log.info(f"Saved samples ({tag}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
