"""Sample from a rectified-flow archive with the port (counterpart of
``examples/rectified_flow/eval_rectified_flow.py``): the sampler is the
ODE integrator, so the knobs are the grid size and the solver (no sampler
swap).

    python -m diffusion_model_nemo_tpu_torch.cli.eval_rectified_flow \\
        model_path=RectifiedFlow.dmn batch_size=16 num_steps=10 solver=heun
    ... show_diffusion=true frame_step=1    # + diffusion.gif

Writes ``sample_<i>.png`` and ``samples_grid.png`` under ``output_dir``
(plus a timestamp directory unless ``add_timestamp=false``), with the
port's own PNG and GIF writers (``utils/image.py``, no Pillow). ``device=cpu``
runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import RectifiedFlow
from ..utils.image import encode_png, save_animation, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, output_dir

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "RectifiedFlow.dmn"
    batch_size: int = 32
    image_size: int = -1

    num_steps: int = -1  # ODE grid size; -1 keeps the archive's sample_steps
    solver: str = ""  # euler | heun; "" keeps the archive's solver

    output_dir: str = "samples"
    add_timestamp: bool = True
    grid_plot: bool = True

    show_diffusion: bool = False
    frame_step: int = 1
    fps: int = 30

    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = RectifiedFlow.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.solver:
        model.change_sampler(dict(model.cfg.sampler, solver=cfg.solver))
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    out = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg),
                       num_steps=cfg.num_steps if cfg.num_steps > 0 else None, return_frames=cfg.show_diffusion)
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
