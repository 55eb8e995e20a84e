"""Sample from an EDM archive with the port (counterpart of
``examples/edm/eval_edm.py``): the archive's Algorithm 2, with the grid
size, the solver and the churn as knobs (no sampler swap).

    python -m diffusion_model_nemo_tpu_torch.cli.eval_edm model_path=EDM.dmn \\
        batch_size=16 num_steps=18 solver=heun s_churn=1.0
    ... label=2 guidance_scale=2.0          # a ConditionalEDM archive
    ... show_diffusion=true frame_step=1    # + diffusion.gif

Writes ``sample_<i>.png`` and ``samples_grid.png`` under ``output_dir``
(plus a timestamp directory unless ``add_timestamp=false``), with the
port's own PNG and GIF writers (``utils/image.py``). ``device=cpu`` runs on
the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import restore_model_from_archive
from ..utils.image import encode_png, save_animation, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "EDM.dmn"
    batch_size: int = 32
    image_size: int = -1

    num_steps: int = -1  # σ-grid size; -1 keeps the archive's sample_steps
    solver: str = ""  # heun | euler; "" keeps the archive's solver
    s_churn: float = -1.0  # stochastic churn; -1 keeps the archive's value

    output_dir: str = "samples"
    add_timestamp: bool = True
    grid_plot: bool = True

    show_diffusion: bool = False
    frame_step: int = 1
    fps: int = 30

    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"

    label: int = -1  # class to sample (ConditionalEDM); -1 = the null class
    guidance_scale: float = -1.0  # classifier-free guidance weight; -1 = off


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.solver or cfg.s_churn >= 0.0:
        sampler_cfg = dict(model.cfg.sampler)
        if cfg.solver:
            sampler_cfg["solver"] = cfg.solver
        if cfg.s_churn >= 0.0:
            sampler_cfg["s_churn"] = cfg.s_churn
        model.change_sampler(sampler_cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    kwargs = {}
    if cfg.label >= 0:
        kwargs["label"] = cfg.label
    if cfg.guidance_scale >= 0.0:
        kwargs["guidance_scale"] = cfg.guidance_scale
    out = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg),
                       num_steps=cfg.num_steps if cfg.num_steps > 0 else None, return_frames=cfg.show_diffusion,
                       **kwargs)
    imgs, frames = out if cfg.show_diffusion else (out, None)
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    if cfg.grid_plot:
        save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=6)
    for i, img in enumerate(to_uint8(imgs)):
        (out_dir / f"sample_{i}.png").write_bytes(encode_png(img))
    if frames is not None:
        save_animation(frames, str(out_dir / "diffusion"), fps=cfg.fps, frame_step=cfg.frame_step)
    log.info(f"Saved {imgs.shape[0]} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
