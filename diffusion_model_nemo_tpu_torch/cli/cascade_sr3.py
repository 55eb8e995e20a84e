"""Cascaded generation from a base archive and SR3 upscaler archives
(counterpart of ``examples/sr3/cascade_sr3.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.cascade_sr3 base_path=DDPM16.dmn \\
        upscaler_paths=SR3_32.dmn,SR3_64.dmn batch_size=8
    ... use_ddim_sampler=true ddim_timesteps=50   # the BASE's sampler (or use_dpm_solver)
    ... upscaler_ddim_timesteps=25                # DDIM-N for every upscaler
    ... label=3 guidance_scale=2.0                # a class-conditional base

The base restores as its own family; stage i draws from a generator seeded
by (seed, i) (``pipelines/cascade.py``). Writes ``stage<i>_<px>px.png``
grids (``save_stages``), ``samples_grid.png`` and ``sample_<i>.png`` under
``output_dir`` with the port's PNG writer. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..pipelines import CascadePipeline
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import output_dir
from .eval_sr3 import DDIM, DPM, swap_sampler

log = logging.getLogger(__name__)


@dataclass
class CascadeConfig:
    base_path: str = "DDPM.dmn"
    upscaler_paths: str = ""  # comma-separated SR3 archives, low to high resolution
    batch_size: int = 8

    # a class-conditional base
    label: int = -1
    guidance_scale: float = 1.0

    # the base's sampler swaps (DPM-Solver++ over DDIM)
    use_ddim_sampler: bool = False
    ddim_timesteps: int = 50
    eta: float = 0.0
    use_dpm_solver: bool = False
    dpm_steps: int = 20
    upscaler_ddim_timesteps: int = 0  # DDIM-N for every upscaler (0 = each archive's sampler)

    output_dir: str = "cascade_samples"
    add_timestamp: bool = True
    save_stages: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=CascadeConfig)
def main(cfg):
    """Returns (the output directory, every stage's images on the device)."""
    cfg = CascadeConfig(**cfg)
    paths = [p for p in cfg.upscaler_paths.split(",") if p.strip()]
    if not paths:
        raise ValueError("cascade_sr3 needs upscaler_paths=<sr3.dmn>[,<sr3.dmn>...]")
    pipe = CascadePipeline.from_archives(cfg.base_path, paths, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.use_dpm_solver:
        swap_sampler(pipe.base, DPM, solver_steps=cfg.dpm_steps)
    elif cfg.use_ddim_sampler:
        swap_sampler(pipe.base, DDIM, eta=cfg.eta, ddim_timesteps=cfg.ddim_timesteps)
    if cfg.upscaler_ddim_timesteps > 0:
        for up in pipe.upscalers:
            swap_sampler(up, DDIM, eta=0.0, ddim_timesteps=cfg.upscaler_ddim_timesteps)
    base_kwargs = {}
    if cfg.label >= 0:
        base_kwargs["label"] = cfg.label
        if cfg.guidance_scale != 1.0:
            base_kwargs["guidance_scale"] = cfg.guidance_scale
    # the weights were chosen at restore (use_ema): sample with them
    stages = pipe.sample(cfg.batch_size, seed=cfg.seed if cfg.seed is not None else 0, return_stages=True,
                         **base_kwargs)
    out_dir = output_dir(cfg)
    if cfg.save_stages:
        for i, s in enumerate(stages):
            save_image_grid(s, str(out_dir / f"stage{i}_{s.shape[1]}px.png"), nrow=6)
    final = stages[-1].float().cpu().numpy()
    save_image_grid(final, str(out_dir / "samples_grid.png"), nrow=6)
    for i, img in enumerate(to_uint8(final)):
        (out_dir / f"sample_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {final.shape[0]} cascaded samples ({' → '.join(str(s.shape[1]) for s in stages)} px) "
             f"to {out_dir}")
    return out_dir, stages


if __name__ == "__main__":
    main()
