"""Sample from a DDPM archive with the port (counterpart of
``examples/ddpm/eval_ddpm.py``): DDIM (default), DPM-Solver++, Karras,
UniPC or the model's own ancestral chain.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_ddpm model_path=DDPM.dmn \\
        use_ddim_sampler=true ddim_timesteps=50 batch_size=64 seed=0
    ... use_dpm_solver=true dpm_steps=20          # overrides DDIM
    ... use_karras_sampler=true karras_steps=18   # overrides both
    ... use_unipc=true unipc_steps=20             # overrides all three
    ... show_diffusion=true frame_step=1 fps=30   # + diffusion.gif

Writes ``sample_<i>.png`` and ``samples_grid.png`` under ``output_dir``
(plus a timestamp directory unless ``add_timestamp=false``), and with
``show_diffusion`` the first sample's trajectory as ``diffusion.gif``.
``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from ..models import DDPM
from ..utils.image import encode_png, save_animation, save_image_grid, to_uint8
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class EvalConfig:
    model_path: str = "DDPM.dmn"
    batch_size: int = 32
    image_size: int = -1

    # DDIM
    use_ddim_sampler: bool = True
    ddim_eta: float = 0.0  # 0 = DDIM mode, 1 = DDPM mode
    ddim_timesteps: int = 10  # -1 uses original timesteps

    # DPM-Solver++ (overrides DDIM when set)
    use_dpm_solver: bool = False
    dpm_steps: int = 20
    dpm_order: int = 2
    dpm_time_spacing: str = "strided"
    use_karras_sampler: bool = False
    karras_steps: int = 18  # EDM / Karras (overrides both)
    karras_order: int = 2
    karras_s_churn: float = 0.0
    use_unipc: bool = False
    unipc_steps: int = 20  # UniPC (overrides all)
    unipc_order: int = 2
    unipc_corrector: bool = True
    unipc_variant: str = "bh2"

    # Output
    output_dir: str = "samples"
    add_timestamp: bool = True
    grid_plot: bool = True

    # animation
    show_diffusion: bool = False
    frame_step: int = 1
    fps: int = 30

    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


def maybe_use_ddim_sampler(model: DDPM, cfg) -> None:
    """The JAX script's sampler swap, with its precedence UniPC > Karras >
    DPM-Solver++ > DDIM (a config without a sampler's fields skips it)."""
    def swap(target: str, **fields) -> None:
        model.change_sampler(dict(model.cfg.sampler, _target_=f"diffusion_model_nemo.modules.{target}", **fields))

    if getattr(cfg, "use_unipc", False):
        swap("UniPCDiffusion", solver_steps=cfg.unipc_steps, solver_order=cfg.unipc_order,
             use_corrector=cfg.unipc_corrector, variant=cfg.unipc_variant)
    elif getattr(cfg, "use_karras_sampler", False):
        swap("KarrasDiffusion", solver_steps=cfg.karras_steps, solver_order=cfg.karras_order,
             s_churn=cfg.karras_s_churn)
    elif getattr(cfg, "use_dpm_solver", False):
        swap("DPMSolverDiffusion", solver_steps=cfg.dpm_steps, solver_order=cfg.dpm_order,
             time_spacing=cfg.dpm_time_spacing)
    elif cfg.use_ddim_sampler:
        sampler_cfg = dict(model.cfg.sampler)
        sampler_cfg["_target_"] = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
        sampler_cfg["eta"] = cfg.ddim_eta
        sampler_cfg["ddim_timesteps"] = cfg.ddim_timesteps
        model.change_sampler(sampler_cfg)


def output_dir(cfg) -> Path:
    """``cfg.output_dir`` (plus a timestamp directory under
    ``add_timestamp``), made."""
    out_dir = Path(cfg.output_dir)
    if cfg.add_timestamp:
        out_dir = out_dir / datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir


def generator_of(model, cfg) -> torch.Generator:
    return torch.Generator(device=model.device).manual_seed(cfg.seed if cfg.seed is not None else 0)


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EvalConfig(**cfg)
    model = DDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    maybe_use_ddim_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    out = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg),
                       return_frames=cfg.show_diffusion)
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
